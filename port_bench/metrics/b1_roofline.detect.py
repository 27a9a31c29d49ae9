"""``b1_roofline.detect``: kernel B1 (the CLIP attention core's forward,
``ops/clip_attention.py``, ``csrc/clip_attention.cu``) in the detection
step, as a share of its roofline.

Each dispatch of padded size B that began inside the traced window runs
``layers`` B1 calls over ``max_boxes`` × B crops in the serving type;
the mean bound of those calls (``benchcore.roofline.b1_call``: bytes
over 3.35 TB/s, or operations over the bf16 peak, whichever is larger)
times the B1 launches the profiler saw, over their device seconds.
Moves ``detect_slo_share``."""

from benchcore.roofline import b1_call

UNIT = "%"
KERNEL = "attn_core_fwd"


def read(layer: dict):
    trace = layer.get("trace")
    if layer.get("traffic") != "detect_http" or trace is None:
        return None
    n, seconds = trace.kernel(KERNEL)
    spans = trace.inside(layer["traced_dispatches"])
    if n == 0 or not spans:
        return None
    cfg, k = layer["cfg"], layer["params"]["max_boxes"]
    bounds = [b1_call(cfg, k * s.info["batch"], cfg["serve_dtype"])[2]
              for s in spans]
    return 100.0 * n * (sum(bounds) / len(bounds)) / seconds
