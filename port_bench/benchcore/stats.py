"""Percentiles.

A tail is taken over every sample, never from medians of chunks. A
failed request enters a latency tail as ``FAILED_MS``, beyond any limit
(JSON has no infinity)."""

from __future__ import annotations

import math

FAILED_MS = 1.0e6


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    closest ranks, over all of ``values``."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

