"""``search_device_ms``: device-busy time per ``Gallery.search`` call,
the union of the device's operations in the traced window over the
search calls that began in it. Moves ``search_p95_ms``."""

UNIT = "ms"


def read(layer: dict):
    trace = layer.get("trace")
    if layer.get("traffic") != "search_inproc" or trace is None:
        return None
    calls = trace.inside(layer["traced_calls"])
    if not calls or trace.busy_s <= 0:
        return None
    return 1e3 * trace.busy_s / len(calls)
