"""The control of each cell's check fails it, on the card, at a size a
test run holds (the full-size controls are ``control.py``'s, recorded in
PERF.md). Run with ``python -m pytest -q -m cuda port_bench/tests``."""

from __future__ import annotations

import pytest

from benchcore import spec

SMALL = {
    "detect_http": {"check_requests": 16},
    "search_inproc": {"rows": 262_144, "check_calls": 16,
                      "calls_per_caller": 16},
    "embed_tree": {"crops": 256, "check_crops": 64},
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [
    "vitb32-detect-steady", "vitl14-detect-steady", "vitb32-search-1m",
    "vitb32-embed-tree"])
def test_the_control_fails_the_check(cuda, bench_control, cell):
    kind = spec.workload(cell)["traffic"]
    for seed in (2 ** 31 + 5, 11):
        out = bench_control.control(cell, seed, 10.0,
                                    params_override=SMALL[kind])
        assert out["failed"], out
