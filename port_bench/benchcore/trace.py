"""Spans recorded by the harness around its calls into the port, and the
profiler window of a traced run.

Each span is a host-clock interval and also a
``torch.profiler.record_function`` range named ``pb.<name>``, so that a
traced run can say what the host was doing while the device idled.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from dataclasses import dataclass, field

SPAN_PREFIX = "pb."


@dataclass
class Span:
    name: str
    start: float
    end: float
    info: dict = field(default_factory=dict)
    wall_ns: int = 0      # time.time_ns() at the start, the trace's clock

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Spans:
    """Thread-safe list of spans; ``reset()`` at the start of the window
    keeps warm-up out of it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, **info):
        from torch.profiler import record_function

        with record_function(SPAN_PREFIX + name):
            wall = time.time_ns()
            start = time.perf_counter()
            try:
                yield info
            finally:
                end = time.perf_counter()
                with self._lock:
                    self._spans.append(Span(name, start, end, info, wall))

    def reset(self) -> None:
        with self._lock:
            self._spans = []

    def of_all(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def of(self, name: str) -> list[Span]:
        """The spans called ``name``."""
        return [s for s in self.of_all() if s.name == name]


@dataclass
class TraceSummary:
    """What a profiler window saw: device operations by name (count,
    seconds), the device-busy seconds (the union of every device
    operation's interval), the window's length, and idle seconds by the
    harness span that was open on the host."""

    window_s: float
    busy_s: float
    t0_ns: int = 0
    t1_ns: int = 0
    ops: dict[str, list] = field(default_factory=dict)   # name -> [n, s]
    idle_by_host: dict[str, float] = field(default_factory=dict)

    def kernel(self, pattern: str) -> tuple[int, float]:
        """(launches, seconds) of the device operations whose name holds
        ``pattern``."""
        n, s = 0, 0.0
        for name, (count, secs) in self.ops.items():
            if pattern in name:
                n += count
                s += secs
        return n, s

    def inside(self, spans: list) -> list:
        """The spans that began inside the traced window."""
        return [s for s in spans if self.t0_ns <= s.wall_ns < self.t1_ns]

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[name, s] for name, (_, s) in ops],
                "idle_gaps": [[name, s] for name, s in gaps]}


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(device_events, host_events, t0_ns: int, t1_ns: int
              ) -> TraceSummary:
    """Reduce raw events to a ``TraceSummary``. ``device_events`` are
    (name, start_ns, end_ns) of operations on the card, ``host_events``
    (name, start_ns, end_ns) of the harness's spans; both clipped to the
    window [t0_ns, t1_ns)."""
    ops: dict[str, list] = {}
    intervals = []
    for name, a, b in device_events:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b <= a:
            continue
        entry = ops.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) / 1e9
        intervals.append((a, b))
    busy = _union(intervals)
    busy_s = sum(b - a for a, b in busy) / 1e9
    # Idle gaps, each named by the innermost harness span open on the host
    # at its midpoint ("outside the harness's spans" where none was).
    gaps, cursor = [], t0_ns
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if t1_ns > cursor:
        gaps.append((cursor, t1_ns))
    host = sorted(host_events, key=lambda e: e[1])
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        label, width = "outside the harness's spans", None
        for name, ha, hb in host:
            if ha > mid:
                break
            if hb >= mid and (width is None or hb - ha < width):
                label, width = name, hb - ha
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    return TraceSummary(window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy_s,
                        t0_ns=t0_ns, t1_ns=t1_ns, ops=ops,
                        idle_by_host=idle)


class DeviceTrace:
    """``torch.profiler`` over part of the measured window, reduced to a
    ``TraceSummary``.

    Only device activity is recorded (kernels, copies, fills): the CUDA
    activity trace holds every operation of the process on the card,
    whichever thread launched it (the port launches from its own threads:
    the micro-batcher's worker, the search callers). Host activity comes
    from the harness's ``Spans``, which carry the same clock, so the
    profiler records no host operations and costs the window little."""

    DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")

    def __init__(self, torch, spans: Spans):
        self.torch = torch
        self.spans = spans
        self._prof = None
        self.summary: TraceSummary | None = None

    def warm(self) -> None:
        """One short session, in set-up: the profiler's first start
        initialises its tracing for seconds, which inside a served
        window stalls the process and builds a queue."""
        self.start()
        if self.torch.cuda.is_available():
            self.torch.ones(1, device="cuda").add_(1)
        self._prof.__exit__(None, None, None)
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = self.torch.cuda.is_available()
        if cuda:
            self.torch.cuda.synchronize()
        # Without a card (the CPU tests) there is no device to record.
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                         else ProfilerActivity.CPU])
        self._prof.__enter__()
        self._t0 = time.time_ns()

    def stop(self) -> TraceSummary:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        device = []
        for e in self._prof.profiler.kineto_results.events():
            if not str(e.device_type()).endswith("CUDA"):
                continue
            # torch 2.11's events carry no activity type: there the
            # harness's own ranges, mirrored on the device's timeline, are
            # told apart by their prefix.
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            if kind in self.DEVICE_ACTIVITIES or (
                    not kind and not e.name().startswith(SPAN_PREFIX)):
                device.append((e.name(), e.start_ns(), e.end_ns()))
        # time.time_ns() is the profiler's clock (wall ns) and the spans'.
        host = [(s.name, s.wall_ns, s.wall_ns + int(s.seconds * 1e9))
                for s in self.spans.of_all()]
        if device:
            first = min(e[1] for e in device) - self._t0
            last = max(e[2] for e in device) - t1
            print(json.dumps({"trace": {
                "device_ops": len(device), "window_ms": (t1 - self._t0) / 1e6,
                "first_after_start_ms": first / 1e6,
                "last_after_stop_ms": last / 1e6}}), file=sys.stderr)
        else:
            print(json.dumps({"trace": {"device_ops": 0}}), file=sys.stderr)
        self.summary = summarize(device, host, self._t0, t1)
        self._prof = None
        return self.summary
