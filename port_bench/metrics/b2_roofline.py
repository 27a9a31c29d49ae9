"""``b2_roofline``: kernel B2 (the int8 gallery scan,
``gallery/search.py`` ``int8_scan_topk`` → ``csrc/int8_scan.cu``), as a
share of its roofline.

Each search call scans the gallery's N rows of D int8 for its Q queries:
N·D + Q·D bytes and the N f32 penalties in, Q·N f32 scores out, over
3.35 TB/s (``benchcore.roofline.b2_call``; its 2·Q·N·D integer operations
at 1,979 TOP/s bound less). The bound times the B2 launches the profiler
saw, over their device seconds. Moves ``search_p95_ms``."""

from benchcore.roofline import b2_call

UNIT = "%"
# B2's kernel, demangled or not; B3 (the int4 scan) has another signature.
NAMES = ("scan(signed char const*, signed char const*, float const*, float*",
         "scanEPKaS1_PKfPf")


def read(layer: dict):
    trace = layer.get("trace")
    if layer.get("traffic") != "search_inproc" or trace is None:
        return None
    n = seconds = 0
    for name, (count, secs) in trace.ops.items():
        if any(pattern in name for pattern in NAMES):
            n += count
            seconds += secs
    if n == 0:
        return None
    p = layer["params"]
    bound = b2_call(p["queries_per_call"], layer["rows"], layer["dim"])[2]
    return 100.0 * n * bound / seconds
