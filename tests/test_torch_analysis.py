"""Port parity: the analysis stage (the 41_* results analysis).

The port computes the classification report and the summary with numpy and
the ``csv`` module; the JAX package with pandas and scikit-learn. On the
same results CSV both must write ``similarity_score_summary.csv`` and every
``metrics/metrics_<case>_<dtype>.csv`` byte for byte, and the port's plain
rows must hold the values of the JAX DataFrames. Oracle:
tests/test_e2e_slice.py:160-185, test_edge_cases.py.
"""

import csv
import math
import sys

import numpy as np
import pytest

from retrieval_based_object_detection_tpu.pipelines import analysis as janalysis
from retrieval_based_object_detection_tpu_torch.pipelines import (
    analysis as tanalysis,
)

CASES = ("pre_a", "pre_b")
DTYPES = ("average", "centroid", "medoid", "weighted")
HEADER = ["experiment_id", "case", "delegate_type", "image_path",
          "true_class", "predicted_class", "similarity_score"]


def _write(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        w.writerows(rows)


def _results(seed, perfect=False, n_classes=5, per_group=24):
    """A results CSV in the experiment grid's layout: every (case, dtype)
    group, true classes from a set, predictions that in nearest mode may
    name a class no test image has."""
    rng = np.random.default_rng(seed)
    classes = [f"class{c}" for c in range(n_classes)]
    rows = []
    for case in CASES:
        for dt in DTYPES:
            for i in range(per_group):
                true = classes[int(rng.integers(0, n_classes - 1))]
                pred = true if perfect or rng.random() < 0.6 else \
                    classes[int(rng.integers(0, n_classes))]
                rows.append([f"{case}_{dt}", case, dt, f"/t/{case}/{i}.png",
                             true, pred, repr(float(rng.uniform(-1, 1)))])
    return rows


def _both(tmp_path, rows):
    out = {}
    for name, mod in (("jax", janalysis), ("port", tanalysis)):
        d = tmp_path / name / "2026-01-01-1"
        d.mkdir(parents=True)
        _write(d / "result_2026-01-01-1.csv", rows)
        out[name] = (d, mod.analyze(d / "result_2026-01-01-1.csv",
                                    make_plots=False))
    return out


def _files(d):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*.csv")) if not p.name.startswith("result")}


@pytest.mark.parametrize("seed,perfect", [(0, True), (1, False), (2, False),
                                          (3, False)])
def test_csvs_are_the_jax_bytes(seed, perfect, tmp_path):
    out = _both(tmp_path, _results(seed, perfect))
    (jd, jres), (td, tres) = out["jax"], out["port"]
    jf, tf = _files(jd), _files(td)
    assert sorted(p for p in tf if p.startswith("metrics")) == [
        f"metrics/metrics_{c}_{d}.csv" for c in CASES for d in DTYPES]
    assert list(tf) == list(jf)
    for name in jf:
        assert tf[name] == jf[name], name
    assert tres["summary_path"].name == jres["summary_path"].name
    # Plain rows where the JAX package returns DataFrames.
    s = jres["summary"]
    assert tres["summary"]["case"] == list(s["case"])
    np.testing.assert_allclose(tres["summary"]["mean"], s["mean"],
                               rtol=1e-12)
    for key, rdf in jres["metrics"].items():
        t = tres["metrics"][key]
        assert t["label"] == list(rdf.index)
        for col in ("precision", "recall", "f1-score", "support"):
            np.testing.assert_allclose(t[col], rdf[col].to_numpy(),
                                       rtol=1e-12)
    if perfect:
        m = tres["metrics"][("pre_a", "average")]
        assert m["precision"][m["label"].index("accuracy")] == 1.0


def test_imperfect_predictions_and_a_single_row_group(tmp_path):
    """The reference's off-diagonal case (accuracy 0.85, recall 0.7), and a
    group of one row, whose std pandas writes as an empty field."""
    rows = [["pre_a_average", "pre_a", "average", f"/x{i}.png", "a",
             "b" if i < 3 else "a", "0.9"] for i in range(10)]
    rows += [["pre_a_average", "pre_a", "average", f"/y{i}.png", "b", "b",
              "0.8"] for i in range(10)]
    rows += [["pre_b_medoid", "pre_b", "medoid", "/z.png", "b", "c", "0.5"]]
    out = _both(tmp_path, rows)
    (jd, _), (td, tres) = out["jax"], out["port"]
    assert _files(td) == _files(jd)
    m = tres["metrics"][("pre_a", "average")]
    assert abs(m["precision"][m["label"].index("accuracy")] - 0.85) < 1e-12
    assert m["recall"][m["label"].index("a")] == 0.7
    assert math.isnan(tres["summary"]["std"][-1])
    assert (td / "similarity_score_summary.csv").read_text().splitlines()[
        -1] == "pre_b,medoid,0.5000,"


def test_find_result_csvs_matches_jax(tmp_path):
    for i in (2, 1):
        d = tmp_path / f"2026-01-0{i}-1"
        d.mkdir()
        _write(d / f"result_2026-01-0{i}-1.csv", _results(i)[:3])
    (tmp_path / "notes.csv").write_text("x\n")
    assert tanalysis.find_result_csvs(tmp_path) == \
        janalysis.find_result_csvs(tmp_path)


def test_plots_through_matplotlib(tmp_path):
    d = tmp_path / "r"
    (d / "score_distribution").mkdir(parents=True)
    _write(d / "result_r.csv", _results(5))
    for c in CASES:
        for dt in DTYPES:
            np.save(d / "score_distribution" / f"{c}_{dt}_scores.npy",
                    np.linspace(0, 1, 7, dtype=np.float32))
    res = tanalysis.analyze(d / "result_r.csv")
    names = sorted(p.name for p in res["plots"])
    assert all(p.exists() and p.stat().st_size > 0 for p in res["plots"])
    assert len([n for n in names if n.startswith("cm_")]) == 8
    assert len([n for n in names if n.endswith("_scores_hist.png")]) == 8
    assert "similarity_score_distribution.png" in names


def test_plots_without_matplotlib_raise_naming_it(tmp_path, monkeypatch):
    d = tmp_path / "r"
    d.mkdir()
    _write(d / "result_r.csv", _results(6)[:5])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tanalysis.analyze(d / "result_r.csv")
    assert not (d / "metrics").exists()
    res = tanalysis.analyze(d / "result_r.csv", make_plots=False)
    assert res["plots"] == [] and not (d / "img").exists()
