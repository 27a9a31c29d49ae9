"""``benchcore/program_gaps.py``: a traced segment's idle gaps named by
the port's spans, and the idle share with a request open."""

from __future__ import annotations

import pytest
from benchcore import program_gaps as pg
from benchcore.trace import summarize

from retrieval_based_object_detection_tpu_torch.utils import (
    logging as port_tracer,
)

WORKER, HANDLER, CALLER = 11, 22, 33


def rec(name, a, b, thread, id_, parent=None):
    return port_tracer.SpanRecord(name, a, b, thread, id_, parent, None, {})


def test_gap_inside_a_dispatch_takes_the_launching_threads_span():
    program = [
        rec("serve.dispatch", 100, 200, WORKER, 1),
        rec("detect.propose", 110, 150, WORKER, 2, 1),
        # A handler decoding on its own thread, narrower than the
        # worker's span: the worker's still names the gap.
        rec("serve.decode", 120, 130, HANDLER, 3),
        rec("serve.queue_wait", 210, 260, WORKER, 4),
        rec("serve.request", 205, 290, HANDLER, 5),
    ]
    host = [("detect_dispatch", 101, 199)]
    gaps = [(120, 130), (170, 190), (230, 240), (300, 320), (400, 410)]
    got = pg.name_gaps(gaps, program, host)
    assert got == pytest.approx({
        "detect.propose": 10e-9, "serve.dispatch": 20e-9,
        "serve.queue_wait": 10e-9, pg.OUTSIDE: 30e-9})


def test_program_span_on_another_thread_before_the_harness():
    program = [rec("search.call", 0, 10, CALLER, 1),
               rec("serve.decode", 50, 80, HANDLER, 2)]
    host = [("search", 40, 90)]
    got = pg.name_gaps([(60, 70), (85, 89)], program, host)
    assert got == pytest.approx({"serve.decode": 10e-9, "search": 4e-9})


@pytest.mark.parametrize("host", [
    [("detect_dispatch", 0, 40)],
    [("outer", 0, 100), ("detect_dispatch", 25, 55), ("tie", 25, 55)],
    [],
])
def test_without_program_spans_it_names_what_summarize_names(host):
    """The gaps of these device events are (0, 10), (30, 50), (60, 100):
    without program spans ``name_gaps`` is ``summarize``'s naming, key
    for key and in its order."""
    device = [("k", 10, 20), ("k", 15, 30), ("m", 50, 60)]
    s = summarize(device, host, 0, 100)
    gaps = [(0, 10), (30, 50), (60, 100)]
    assert sum(b - a for a, b in gaps) / 1e9 == pytest.approx(
        s.window_s - s.busy_s)
    got = pg.name_gaps(gaps, [], host)
    assert list(got.items()) == list(s.idle_by_host.items())


def test_idle_with_work_counts_idle_time_under_an_open_request():
    gaps = [(0, 10), (30, 50), (60, 100)]
    requests = [(5, 35), (40, 45), (90, 200)]
    # 5 + (5 + 5) + 10 of 100.
    assert pg.idle_with_work(gaps, requests, 0, 100) == pytest.approx(0.25)
    assert pg.idle_with_work(gaps, [], 0, 100) is None
