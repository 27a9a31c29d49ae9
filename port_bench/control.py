"""The control of a cell's correctness check: the plain reference put in
the program's place one precision below the configuration's, on several
seeds, judged by the cell's own comparison. Every control has to fail at
least one of the cell's numbers; the smallest reading of each number over
the seeds is its upper reading, from which its limit is set.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3

The benchmark's own runs never run it. Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchcore import device as devlib  # noqa: E402
from benchcore import spec  # noqa: E402
from benchcore.context import Check, Run  # noqa: E402


def control(name: str, seed: int, seconds: float, device: str = "cuda",
            root: Path = spec.BENCH_ROOT, cfg_override=None,
            params_override=None) -> dict:
    """One seed of cell ``name``'s control → each number, its limit and
    whether the control failed it."""
    import torch

    cell = spec.workload(name, root)
    cfg = {**spec.config(cell["config"], root), **(cfg_override or {})}
    cell = {**cell, "params": {**cell["params"], **(params_override or {})}}
    run = Run(torch=torch, name=name, spec=cell, cfg=cfg, seed=seed,
              seconds=seconds, trace=False, device=torch.device(device),
              t_process=time.perf_counter())
    nums = spec.traffic(cell["traffic"], root).control(run)
    checks = [Check(k, float(v), float(cell["limits"][k]))
              for k, v in nums.items()]
    return {"workload": name, "seed": seed,
            "failed": [c.name for c in checks if not c.ok],
            "numbers": {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    devlib.set_cache_dirs(BENCH.parent)
    import torch

    devlib.require_cuda(torch, 1)
    rc = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        out = control(args.workload, seed, args.seconds)
        print(json.dumps(out), flush=True)
        rc = rc or (0 if out["failed"] else 1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
