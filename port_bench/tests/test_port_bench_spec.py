"""The harness finds cells, configurations, traffic kinds and metrics by
name from files alone, and BENCHMARK.json agrees with the files."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchcore import spec
from benchcore.context import Check, Outcome, Run, result_line

BENCH = Path(__file__).resolve().parents[1]

BENCHMARK = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_new_files_alone_add_a_cell_a_config_a_kind_and_a_metric(tmp_path):
    root = tmp_path / "bench"
    for sub in ("workloads", "configs", "traffic", "metrics"):
        (root / sub).mkdir(parents=True)
    (root / "configs" / "toy-model.json").write_text(json.dumps(
        {"name": "toy-model", "width": 8}))
    (root / "workloads" / "toy-cell.json").write_text(json.dumps(
        {"name": "toy-cell", "config": "toy-model", "traffic": "toy_kind",
         "chips": 1, "why": "a test", "params": {"n": 3},
         "limits": {"gap": 0.5}}))
    (root / "traffic" / "toy_kind.py").write_text(
        "from benchcore.context import Outcome\n"
        "def run(run):\n"
        "    n = run.params['n'] * run.cfg['width']\n"
        "    return Outcome(attempted=n, failed=0,\n"
        "                   end_to_end={'toy_rate': (float(n), 'items/s')},\n"
        "                   checks=[run.check('gap', 0.25)],\n"
        "                   device={'platform': 'cpu'},\n"
        "                   layer={'traffic': 'toy_kind', 'n': n})\n")
    (root / "metrics" / "toy.metric.py").write_text(
        "UNIT = 'items'\n"
        "def read(layer):\n"
        "    return layer['n'] if layer.get('traffic') == 'toy_kind' "
        "else None\n")
    cell = spec.workload("toy-cell", root)
    assert spec.config(cell["config"], root)["width"] == 8
    assert spec.metric_names(root) == ["toy.metric"]
    kind = spec.traffic(cell["traffic"], root)
    import torch

    run = Run(torch=torch, name="toy-cell", spec=cell,
              cfg=spec.config("toy-model", root), seed=1, seconds=1.0,
              trace=True, device=torch.device("cpu"), t_process=0.0)
    run.setup_s = 1.5
    line = result_line(kind.run(run), run, spec.metrics(root))
    assert line["metrics"] == {"toy.metric": {"value": 24.0,
                                              "unit": "items"}}
    assert line["correct"] is True
    run.trace = False
    line = result_line(kind.run(run), run, {})
    assert line["metrics"]["toy_rate"] == {"value": 24.0, "unit": "items/s"}


def test_a_name_with_no_file_is_refused(tmp_path):
    with pytest.raises(spec.SpecError):
        spec.workload("no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.workload("../escape")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_every_cell_has_its_files(cell):
    w = spec.workload(cell)
    entry = next(e for e in BENCHMARK["workloads"] if e["name"] == cell)
    assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    spec.config(w["config"])
    kind = spec.traffic(w["traffic"])
    assert callable(kind.run) and callable(kind.control)
    assert set(w["limits"]) and all(
        isinstance(v, (int, float)) for v in w["limits"].values())


def test_benchmark_json_keeps_to_its_contract():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert all(Path(BENCH.parent / p).is_dir() for p in b["paths"])
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert json.loads((BENCH.parent / c["file"]).read_text())[
            "name"] == c["name"]
    cells = {w["name"] for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    metric_files = set(spec.metric_names())
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["name"] in metric_files
        mod = spec.load_module("metrics", m["name"])
        assert mod.UNIT == m["unit"]
    for cell in cells:
        reported = [m for m in b["end_to_end"]
                    if cell in m.get("workloads", cells)
                    and m["name"] != "setup_s"]
        assert reported, cell
        assert any(cell in m["workloads"] for m in b["per_layer"]), cell


def test_checks_come_last_in_the_line():
    import torch

    run = Run(torch=torch, name="c", spec={"params": {}, "limits": {}},
              cfg={}, seed=1, seconds=1.0, trace=False,
              device=torch.device("cpu"), t_process=0.0)
    run.setup_s = 2.0
    out = Outcome(attempted=3, failed=1,
                  end_to_end={"x_ms": (4.0, "ms")},
                  checks=[Check("gap", 0.5, 0.25)],
                  device={"platform": "gpu", "kind": "k", "count": 1,
                          "memory_peak_bytes": 7})
    line = result_line(out, run, {})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is False
    assert line["checks"] == {"gap": {"value": 0.5, "limit": 0.25}}
    json.dumps(line, allow_nan=False)


def test_a_copy_of_the_folder_runs_without_the_repo(tmp_path):
    """Copied beside nothing but itself, the folder still finds its
    cells (and would then fail to import the port)."""
    copy = tmp_path / "port_bench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for cell in {w["name"] for w in BENCHMARK["workloads"]}:
        assert spec.workload(cell, copy)["name"] == cell
