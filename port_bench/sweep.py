"""Knee sweep of a ``detect_http`` cell: the highest open-loop rate the
service sustains, found on repeated windows.

    python3 port_bench/sweep.py --workload <cell> --seed <n> \
        --seconds <s> --rates 8,16,24,... [--passes 2] [--schedules 2]

One set-up (as ``run.py`` makes it, from ``--seed``), then ``--passes``
passes over the rates, lowest first; each pass sends every rate
``--schedules`` windows, each window's arrivals and uploads drawn from a
seed of its own (``--seed`` + pass × schedules + j). A window holds when

- no request failed;
- no backlog grew: the median latency of its last quarter of requests is
  under 1.5 × that of its first quarter (a backlog that grows through
  the window raises it long before the end);
- its p95 is at most twice the light-load p95, the median over the
  windows of the lowest rate (the latency knee: past it, the
  micro-batcher absorbs more load by larger batches, no backlog grows,
  and the tail is several times the light-load tail and swings from run
  to run).

The knee is the highest rate at which every window held, as did every
window of every lower rate. Prints one JSON line per window and the
knee last, with ``monotonic`` false where a window above the knee held
again (a boundary that does not repeat). The cell's rate is then set to
0.8 × the knee in its file.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchcore import device as devlib  # noqa: E402
from benchcore import spec, stats  # noqa: E402
from benchcore.context import Run  # noqa: E402

BACKLOG_RATIO = 1.5
KNEE_RATIO = 2.0


def window_row(kind, records, rate: float, seed: int) -> dict:
    lat = kind.latencies_ms(records)
    q = max(1, len(lat) // 4)
    return {"rate_per_s": rate, "schedule_seed": seed,
            "requests": len(records),
            "failed": sum(1 for r in records if not r or r[3] != 200),
            "p50_ms": stats.percentile(lat, 50),
            "p95_ms": stats.percentile(lat, 95),
            "first_quarter_p50_ms": stats.percentile(lat[:q], 50),
            "last_quarter_p50_ms": stats.percentile(lat[-q:], 50)}


def knee_of(rows: list[dict]) -> dict:
    """Each window judged (``held`` added to each row) → the knee, the
    light-load p95 and whether the boundary is monotonic."""
    rates = sorted({r["rate_per_s"] for r in rows})
    light = statistics.median(r["p95_ms"] for r in rows
                              if r["rate_per_s"] == rates[0])
    for r in rows:
        r["held"] = (r["failed"] == 0
                     and r["last_quarter_p50_ms"]
                     < BACKLOG_RATIO * r["first_quarter_p50_ms"]
                     and r["p95_ms"] <= KNEE_RATIO * light)
    knee = None
    for rate in rates:
        if not all(r["held"] for r in rows if r["rate_per_s"] == rate):
            break
        knee = rate
    above = [r for r in rows if knee is None or r["rate_per_s"] > knee]
    first_fail = min((r["rate_per_s"] for r in above if not r["held"]),
                     default=None)
    monotonic = not any(r["held"] for r in above
                        if first_fail is not None
                        and r["rate_per_s"] > first_fail)
    return {"knee_per_s": knee, "light_p95_ms": light,
            "monotonic": monotonic,
            "rate_at_0.8": None if knee is None else 0.8 * knee}


def sweep(name: str, seed: int, seconds: float, rates: list[float],
          passes: int = 2, schedules: int = 2, device: str = "cuda",
          cfg_override=None, params_override=None):
    """→ (one row a window, the knee's summary)."""
    import torch

    cell = spec.workload(name)
    cfg = {**spec.config(cell["config"]), **(cfg_override or {})}
    cell = {**cell, "params": {**cell["params"], **(params_override or {})}}
    kind = spec.traffic(cell["traffic"])
    run = Run(torch=torch, name=name, spec=cell, cfg=cfg, seed=seed,
              seconds=seconds, trace=False, device=torch.device(device),
              t_process=time.perf_counter())
    server, port, _, _, uploads, _, _, _ = kind.build_service(run)
    rows = []

    def window(rate: float, win_seed: int, win_seconds: float, tag: int):
        workdir = tempfile.mkdtemp(prefix="pb-sweep-")
        try:
            sched = kind.schedule(win_seed, rate, win_seconds, len(uploads),
                                  tag)
            return kind.drive(run, port, uploads, sched, win_seconds,
                              workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)

    try:
        warm = cell["params"]["warm_seconds"]
        window(min(rates), seed, warm, 4)
        for n in range(passes):
            for rate in sorted(rates):
                for j in range(schedules):
                    win_seed = seed + n * schedules + j
                    row = window_row(kind, window(rate, win_seed, seconds, 2),
                                     rate, win_seed)
                    row["pass"] = n
                    print(json.dumps(row), flush=True)
                    rows.append(row)
                    time.sleep(1.0)
    finally:
        server.shutdown()
        server.server_close()
    return rows, knee_of(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--schedules", type=int, default=2)
    args = ap.parse_args(argv)
    devlib.set_cache_dirs(BENCH.parent)
    import torch

    devlib.host_threads(torch)
    devlib.require_cuda(torch, 1)
    print(f"sweep: {devlib.card_note()}", file=sys.stderr)
    rates = [float(r) for r in args.rates.split(",")]
    rows, knee = sweep(args.workload, args.seed, args.seconds, rates,
                       args.passes, args.schedules)
    for r in rows:
        print(json.dumps({k: r[k] for k in ("rate_per_s", "schedule_seed",
                                            "p95_ms", "held")}))
    print(json.dumps({"workload": args.workload, **knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
