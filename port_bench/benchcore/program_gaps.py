"""A traced segment's idle gaps named by the port's own spans.

``summarize`` (``trace.py``) names each gap by the innermost harness span
open at its midpoint. ``name_gaps`` takes the port's spans first, and
``idle_with_work`` gives the share of the segment in which the card idled
while a request was open. Both take the gaps as ``summarize`` finds them,
so that it can hand them on once it takes the program's spans as an
optional argument; with no program spans, ``name_gaps`` returns what
``summarize`` names today, in the same order.
"""

from __future__ import annotations

from benchcore.trace import _union

OUTSIDE = "outside the harness's spans"
# Spans opened on a thread that launches device work: the micro-batcher's
# worker and a search caller.
LAUNCHING = ("serve.dispatch", "search.call")


def _innermost(spans, t: int) -> str | None:
    """The name of the narrowest of ``spans`` (name, start, end) open at
    ``t``; the first of equals."""
    best, width = None, None
    for name, a, b in spans:
        if a <= t <= b and (width is None or b - a < width):
            best, width = name, b - a
    return best


def name_gaps(gaps, program, host) -> dict[str, float]:
    """Idle seconds of each gap (start_ns, end_ns) put down to, in this
    order: the innermost program span open at its midpoint on a thread
    that launches device work (one that opened a ``LAUNCHING`` span);
    else the innermost program span open on any thread; else the
    innermost harness span; else ``OUTSIDE``. ``program`` holds the
    tracer's ``SpanRecord``s, ``host`` the harness's (name, start_ns,
    end_ns)."""
    launching = {s.thread for s in program if s.name in LAUNCHING}
    anywhere = [(s.name, s.start_ns, s.end_ns) for s in program]
    on_launch = [(s.name, s.start_ns, s.end_ns) for s in program
                 if s.thread in launching]
    host = sorted(host, key=lambda e: e[1])
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        label = (_innermost(on_launch, mid) or _innermost(anywhere, mid)
                 or _innermost(host, mid) or OUTSIDE)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    return idle


def idle_with_work(gaps, requests, t0: int, t1: int) -> float | None:
    """The share of [t0, t1) in which the card idled while at least one
    of ``requests`` (start_ns, end_ns) was open; None without any."""
    if not requests:
        return None
    held = _union([(max(a, t0), min(b, t1)) for a, b in requests
                   if min(b, t1) > max(a, t0)])
    both, j = 0, 0
    for a, b in gaps:
        while j < len(held) and held[j][1] <= a:
            j += 1
        k = j
        while k < len(held) and held[k][0] < b:
            both += min(b, held[k][1]) - max(a, held[k][0])
            k += 1
    return both / (t1 - t0)
