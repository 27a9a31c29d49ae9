"""``idle_share.search``: the share of the traced window in which no
operation ran on the card (1 − busy / window, the busy seconds the union
of every device operation's interval), in cells of traffic ``search_inproc``.
Moves ``search_p95_ms``."""

UNIT = "%"


def read(layer: dict):
    trace = layer.get("trace")
    if layer.get("traffic") != "search_inproc" or trace is None \
            or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
