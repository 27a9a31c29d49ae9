"""``detect_latency_p95_ms``: the 95th percentile of every ``POST /detect``
latency of the window, from when the request was due (open loop) to the
end of its answer; a failed request counts as ``FAILED_MS``. Host clock.
It swings with the speed of the shared host (PERF.md §2), so it stands
here and not end to end. Moves ``detect_slo_share``."""

from benchcore import stats

UNIT = "ms"


def read(layer: dict):
    if layer.get("traffic") != "detect_http" or not layer["latencies_ms"]:
        return None
    return stats.percentile(layer["latencies_ms"], 95)
