"""Structured stage logging, throughput counters and the port's tracer.

The reference reports per-stage console summaries (11:196-202, 31:184-186,
33:199-204). Here every pipeline stage can emit a structured summary line
(human text to stderr, one JSON record to an optional log file), and hot
loops can wrap a ThroughputTimer to report items/sec. Host-only code,
copied from the JAX package's ``utils/logging.py``; ``profile_trace``
captures with ``torch.profiler`` instead of ``jax.profiler``.

The tracer (``span``, ``count`` and the functions beside them) records
the serving and search paths' stages: spans kept in memory while tracing
is on (off by default), and counters that are always on.
"""

from __future__ import annotations

import collections
import itertools
import json
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class StageLogger:
    stage: str
    log_file: str | Path | None = None
    _t0: float = field(default_factory=time.perf_counter)

    def event(self, name: str, **fields: Any) -> None:
        rec = {"stage": self.stage, "event": name,
               "t": round(time.perf_counter() - self._t0, 4), **fields}
        print(f"[{self.stage}] {name}: " +
              " ".join(f"{k}={v}" for k, v in fields.items()),
              file=sys.stderr)
        if self.log_file:
            with open(self.log_file, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")

    def summary(self, **fields: Any) -> None:
        self.event("summary", elapsed_s=round(time.perf_counter() - self._t0, 3),
                   **fields)


@dataclass
class ThroughputTimer:
    """items/sec counter for hot loops (batched embed, search)."""

    name: str = "items"
    n: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def add(self, k: int = 1) -> None:
        self.n += k

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def per_sec(self) -> float:
        return self.n / max(self.elapsed, 1e-9)

    def report(self) -> str:
        return f"{self.name}: {self.n} in {self.elapsed:.2f}s " \
               f"({self.per_sec:.1f}/s)"


# ---------------------------------------------------------------- tracer


@dataclass(slots=True)
class SpanRecord:
    """One span: ``start_ns`` and ``end_ns`` on ``time.time_ns()``, the
    clock of ``torch.profiler``'s events; the thread that ran it; its id,
    the id of the span that caused it, and the request it served (every
    span of one ``/detect`` request carries the same one)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int | None
    request: int | None
    info: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _NoSpan:
    """What ``span()`` returns while tracing is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        return False


NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("tracer", "rec", "stack", "range")

    def __init__(self, tracer: "Tracer", rec: SpanRecord, stack: list):
        self.tracer, self.rec, self.stack = tracer, rec, stack
        self.range = None

    def __enter__(self) -> SpanRecord:
        self.stack.append(self.rec)
        if self.tracer.ranges:
            from torch.profiler import record_function

            self.range = record_function(RANGE_PREFIX + self.rec.name)
            self.range.__enter__()
        self.rec.start_ns = time.time_ns()
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        self.tracer._keep(self.rec)
        return False


# Program ranges in a ``torch.profiler`` trace: ``rbod.<span name>``.
RANGE_PREFIX = "rbod."


class Tracer:
    """Spans and counters of one process.

    Spans are recorded only between ``enable()`` and ``disable()``, into
    a bounded buffer (the oldest go first; ``tracer.spans_dropped``
    counts them) that ``spans()`` copies out once a run ends. While off,
    ``span()`` reads one flag and returns ``NO_SPAN``. A span's parent is
    the innermost span open on its thread; work handed to another thread
    names its cause with ``record(..., parent=..., request=...)``.

    Counters are always on and only grow: a reader takes the difference
    of two ``counters()`` reads. ``reset()`` drops the spans only.

    ``ranges`` (set by ``profile_trace`` alone) makes every span also a
    ``torch.profiler.record_function`` range ``rbod.<name>``. Nowhere
    else: torch mirrors such ranges onto the device's timeline, and the
    benchmark's traced segment (``port_bench/benchcore/trace.py``) counts
    every range there not named ``pb.*`` as a device operation."""

    MAX_SPANS = 1 << 18

    def __init__(self, max_spans: int = MAX_SPANS):
        self.on = False
        self.ranges = False
        self._spans: collections.deque[SpanRecord] = collections.deque(
            maxlen=max_spans)
        self._counters: dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, *, request: int | None = None, **info):
        """Context manager timing a stage; yields its ``SpanRecord`` (None
        while off). ``request`` defaults to the enclosing span's."""
        if not self.on:
            return NO_SPAN
        stack = self._stack()
        parent = stack[-1] if stack else None
        if request is None and parent is not None:
            request = parent.request
        rec = SpanRecord(name, 0, 0, threading.get_ident(), next(self._ids),
                         None if parent is None else parent.id, request,
                         info)
        return _OpenSpan(self, rec, stack)

    def record(self, name: str, start_ns: int, end_ns: int, *,
               parent: int | None = None, request: int | None = None,
               **info) -> None:
        """A span timed elsewhere (a wait that ends on another thread)."""
        if self.on:
            self._keep(SpanRecord(name, start_ns, end_ns,
                                  threading.get_ident(), next(self._ids),
                                  parent, request, info))

    def current(self) -> SpanRecord | None:
        """The innermost span open on this thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def new_request(self) -> int | None:
        """A fresh request id while on, else None."""
        return next(self._ids) if self.on else None

    def _keep(self, rec: SpanRecord) -> None:
        if len(self._spans) == self._spans.maxlen:
            self.count("tracer.spans_dropped")
        self._spans.append(rec)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def reset(self) -> None:
        self._spans.clear()

    def spans(self) -> list[SpanRecord]:
        return list(self._spans)

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)


# The process's tracer, and its methods as the module's functions.
TRACER = Tracer()
span = TRACER.span
record = TRACER.record
current = TRACER.current
new_request = TRACER.new_request
count = TRACER.count
enable = TRACER.enable
disable = TRACER.disable
reset = TRACER.reset
spans = TRACER.spans
counters = TRACER.counters


@contextmanager
def profile_trace(out_dir: str | Path | None):
    """``torch.profiler`` trace of the host and, where there is one, the
    GPU, written as a Chrome trace into ``out_dir``; None is a no-op (keeps
    call sites unconditional). Tracing is on inside it, each span a
    ``rbod.<name>`` range on the trace's timeline."""
    if out_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    was = TRACER.on, TRACER.ranges
    TRACER.on = TRACER.ranges = True
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        TRACER.on, TRACER.ranges = was
    prof.export_chrome_trace(str(out / "trace.json"))
