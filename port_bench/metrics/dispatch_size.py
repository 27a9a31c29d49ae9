"""``dispatch_size``: real requests per ``detect`` dispatch of the
micro-batcher (``pipelines/serve.py`` ``MicroBatcher``).

Every request of the window that was answered went through exactly one
dispatch after the window opened, and nothing else was sent, so the mean
is the answered requests over the dispatches the harness's detector
wrapper counted. Moves ``detect_slo_share``."""

UNIT = "requests"


def read(layer: dict):
    if layer.get("traffic") != "detect_http" or not layer["dispatches"]:
        return None
    return layer["requests_ok"] / len(layer["dispatches"])
