"""``step_mfu``: the detection step's share of the card's bf16 peak.

The tower's forward operations (``benchcore.roofline.clip_forward_flops``)
for the real requests' crops (``max_boxes`` a request; padding is not
useful work), over the summed host-clock time of the dispatches and the
configuration's peak for its serving type (989 TFLOP/s bf16). Moves
``detect_slo_share``."""

from benchcore.roofline import clip_forward_flops

UNIT = "%"


def read(layer: dict):
    if layer.get("traffic") != "detect_http" or not layer["dispatches"]:
        return None
    cfg = layer["cfg"]
    flops = (clip_forward_flops(cfg) * layer["params"]["max_boxes"]
             * layer["requests_ok"])
    seconds = sum(s.seconds for s in layer["dispatches"])
    peak = cfg["peak_tflops"][cfg["serve_dtype"]] * 1e12
    return 100.0 * flops / seconds / peak
