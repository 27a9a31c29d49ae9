"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell (``workloads/<cell>.json``), its configuration
(``configs/<config>.json``) and its traffic kind (``traffic/<kind>.py``),
sets up on the card, warms every shape the cell uses, measures for
``--seconds``, checks the answers against ``reference/``, and prints one
JSON line last on standard output. With ``--trace 0`` it holds the cell's
end-to-end metrics; with ``--trace 1`` every per-layer metric
(``metrics/<metric>.py``) that finds something to read, with the
profiler's busy and window seconds and a breakdown. The numbers compared
are printed beside their limits, last on standard error and under
``checks`` in the line.

Exit codes: 0 a result was printed; 3 no card, or fewer than the cell
asks for; 4 JAX or the JAX package was loaded; 2 bad arguments or a
name with no file; anything else, a failure (no result).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
for p in (str(BENCH), str(CHECKOUT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchcore import device as devlib  # noqa: E402
from benchcore import spec  # noqa: E402
from benchcore.context import Run, result_line  # noqa: E402


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = spec.BENCH_ROOT,
             cfg_override: dict | None = None,
             params_override: dict | None = None,
             t_process: float | None = None) -> dict:
    """One run of cell ``name`` → the result line's dict. ``device``,
    ``cfg_override`` and ``params_override`` exist for the CPU tests,
    which run a cell at a tiny size without a card."""
    import torch

    cell = spec.workload(name, root)
    cfg = {**spec.config(cell["config"], root), **(cfg_override or {})}
    cell = {**cell, "params": {**cell["params"], **(params_override or {})}}
    kind = spec.traffic(cell["traffic"], root)
    run = Run(torch=torch, name=name, spec=cell, cfg=cfg, seed=seed,
              seconds=seconds, trace=trace, device=torch.device(device),
              t_process=T_PROCESS if t_process is None else t_process)
    outcome = kind.run(run)
    return result_line(outcome, run, spec.metrics(root) if trace else {})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    devlib.set_cache_dirs(CHECKOUT)
    try:
        cell = spec.workload(args.workload)
    except spec.SpecError as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    import torch

    devlib.host_threads(torch)
    try:
        devlib.require_cuda(torch, cell["chips"])
    except devlib.NoDevice as e:
        print(f"port_bench: {e}; no result", file=sys.stderr)
        return 3
    print(f"port_bench: {devlib.card_note()}; torch {torch.__version__}",
          file=sys.stderr, flush=True)
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace))
    found = devlib.forbidden_loaded()
    if found:
        print(f"port_bench: loaded in this process: {', '.join(found)}; "
              "no result", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
