"""The knee sweep's judgement of its windows, and the load generator's
one try per request."""

from __future__ import annotations

import importlib.util
import socket

from conftest import BENCH


def load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, BENCH / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


sweep = load("sweep.py", "pb_sweep_under_test")
loadgen = load("benchcore/loadgen.py", "pb_loadgen_under_test")


def row(rate, p95, first=100.0, last=100.0, failed=0):
    return {"rate_per_s": rate, "p95_ms": p95, "failed": failed,
            "first_quarter_p50_ms": first, "last_quarter_p50_ms": last}


def test_knee_is_the_highest_rate_every_window_held():
    rows = [row(10, 100), row(10, 110), row(20, 150), row(20, 190),
            row(30, 150), row(30, 250), row(40, 900)]
    k = sweep.knee_of(rows)
    assert k["knee_per_s"] == 20 and k["light_p95_ms"] == 105
    assert k["monotonic"]
    assert k["rate_at_0.8"] == 16


def test_a_failure_or_a_growing_backlog_fails_a_window():
    assert sweep.knee_of([row(10, 100), row(20, 100, failed=1)]
                         )["knee_per_s"] == 10
    assert sweep.knee_of([row(10, 100), row(20, 100, last=160)]
                         )["knee_per_s"] == 10


def test_a_boundary_that_does_not_repeat_is_flagged():
    rows = [row(10, 100), row(20, 300), row(30, 120)]
    k = sweep.knee_of(rows)
    assert k["knee_per_s"] == 10 and not k["monotonic"]


def test_a_refused_request_is_failed_after_one_try():
    with socket.socket() as s:      # a port that nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    status, text = loadgen._send(f"http://127.0.0.1:{port}/detect", b"x",
                                 5.0)
    assert status == 0 and "Refused" in text
