"""Structured stage logging + throughput counters.

The reference reports per-stage console summaries (11:196-202, 31:184-186,
33:199-204). Here every pipeline stage can emit a structured summary line
(human text to stderr, one JSON record to an optional log file), and hot
loops can wrap a ThroughputTimer to report items/sec. Host-only code,
copied from the JAX package's ``utils/logging.py``; ``profile_trace``
captures with ``torch.profiler`` instead of ``jax.profiler``.
"""

from __future__ import annotations

import json
import sys
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


@contextmanager
def profile_trace(out_dir: str | Path | None):
    """``torch.profiler`` trace of the host and, where there is one, the
    GPU, written as a Chrome trace into ``out_dir``; None is a no-op (keeps
    call sites unconditional)."""
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
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
