"""``b1_roofline.embed``: kernel B1 in the offline ingest's f32 tower
(``pipelines/embed.py`` ``make_encoder``), as a share of its roofline.

Every encoder call is one batch of ``embed_batch`` crops, so every B1
call has the same bound (``benchcore.roofline.b1_call``, f32: bytes over
3.35 TB/s against operations at 3xTF32's derived 165 TFLOP/s); the
bound times the B1 launches the profiler saw, over their device
seconds. Moves ``embed_crops_per_s``."""

from benchcore.roofline import b1_call

UNIT = "%"
KERNEL = "attn_core_fwd"


def read(layer: dict):
    trace = layer.get("trace")
    if layer.get("traffic") != "embed_tree" or trace is None:
        return None
    n, seconds = trace.kernel(KERNEL)
    if n == 0:
        return None
    cfg = layer["cfg"]
    bound = b1_call(cfg, cfg["embed_batch"], cfg["embed_dtype"])[2]
    return 100.0 * n * bound / seconds
