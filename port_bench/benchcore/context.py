"""What a traffic kind is handed (``Run``) and what it hands back
(``Outcome``), and the result line made from them."""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any

from benchcore.trace import DeviceTrace, Spans

# A compared number for an answer that is missing or unmatched: beyond any
# limit, and finite, as JSON needs.
MISSING = 1.0e6


@dataclass
class Check:
    """One number of the correctness comparison, beside its limit; the
    run is correct when every number is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict[str, float]
    checks: list[Check]
    device: dict
    # What the per-layer metric readers read: spans, counts, the trace.
    layer: dict[str, Any] = field(default_factory=dict)


@dataclass
class Run:
    torch: Any
    name: str
    spec: dict            # the cell's file
    cfg: dict             # the configuration's file
    seed: int
    seconds: float
    trace: bool
    device: Any           # torch.device
    t_process: float      # time.perf_counter() when the process started
    spans: Spans = field(default_factory=Spans)
    setup_s: float | None = None

    @property
    def params(self) -> dict:
        return self.spec["params"]

    @property
    def limits(self) -> dict:
        return self.spec.get("limits", {})

    def log(self, **fields) -> None:
        import json

        print(json.dumps({"cell": self.name, **fields}), file=sys.stderr,
              flush=True)

    def setup_done(self) -> None:
        """The first timed request is about to go: set-up ends here."""
        self.setup_s = time.perf_counter() - self.t_process

    def profiler(self) -> DeviceTrace | None:
        """With ``--trace 1`` a warmed profiler, made in set-up."""
        if not self.trace:
            return None
        prof = DeviceTrace(self.torch, self.spans)
        prof.warm()
        return prof

    def check(self, name: str, value: float) -> Check:
        """``value`` beside the cell's limit for ``name``."""
        return Check(name, float(value), float(self.limits[name]))


def result_line(outcome: Outcome, run: Run, metric_readers: dict) -> dict:
    """The last line: with ``--trace 0`` the cell's end-to-end metrics,
    with ``--trace 1`` every per-layer metric whose reader finds
    something; the compared numbers come last."""
    if run.trace:
        metrics = {}
        for name, mod in metric_readers.items():
            value = mod.read(outcome.layer)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": mod.UNIT}
    else:
        metrics = {"setup_s": {"value": run.setup_s, "unit": "s"}}
        for name, (value, unit) in outcome.end_to_end.items():
            metrics[name] = {"value": float(value), "unit": unit}
    line = {
        "correct": all(c.ok for c in outcome.checks) and bool(outcome.checks),
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": dict(outcome.device),
    }
    trace = outcome.layer.get("trace")
    if run.trace and trace is not None:
        line["device"]["busy_s"] = trace.busy_s
        line["device"]["window_s"] = trace.window_s
        line["breakdown"] = trace.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return line
