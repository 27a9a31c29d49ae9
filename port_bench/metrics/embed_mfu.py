"""``embed_mfu``: offline ingest's share of the card's f32 peak.

The tower's forward operations (``benchcore.roofline.clip_forward_flops``)
of every crop embedded in the window, over the window's seconds and the
configuration's peak for its embedding type (67 TFLOP/s f32 on the CUDA
cores, the rate of the f32 products; B1 f32 runs on the tensor cores by
3xTF32 and is a small share). Moves ``embed_crops_per_s``."""

from benchcore.roofline import clip_forward_flops

UNIT = "%"


def read(layer: dict):
    if layer.get("traffic") != "embed_tree" or not layer["crops"]:
        return None
    cfg = layer["cfg"]
    peak = cfg["peak_tflops"][cfg["embed_dtype"]] * 1e12
    return (100.0 * clip_forward_flops(cfg) * layer["crops"]
            / layer["window_s"] / peak)
