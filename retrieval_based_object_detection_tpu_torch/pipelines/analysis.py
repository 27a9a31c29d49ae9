"""Results analysis & visualization (the 41_* stage).

Produces, for a chosen result CSV, the same artifact set as the reference
(41_results_analysis_and_visualization.py):

  similarity_score_summary.csv        groupby(case, delegate_type) mean/std (41:40-45)
  metrics/metrics_<case>_<dtype>.csv  classification report per group (41:90-104)
  img/cm_<case>_<dtype>.png           confusion matrices (41:58-73)
  img/similarity_score_distribution.png  boxplot by dtype × case (41:76-88)
  img/<exp>_scores_hist.png           histogram per .npy score file (41:106-125)

The port of the JAX package's ``pipelines/analysis.py`` without pandas and
scikit-learn: the CSVs are read and written with the ``csv`` module, and
the classification report is sklearn's ``classification_report(
output_dict=True, zero_division=0)`` written out with numpy — one row per
class of the union of true and predicted classes, then ``accuracy`` (one
value in every column, ``support`` too, as pandas' transpose lays it out),
``macro avg`` and ``weighted avg`` — so both CSVs are byte for byte the JAX
package's (``float_format="%.4f"``, the summary's ``std`` with ddof = 1, an
empty field where pandas writes NaN). ``analyze`` returns the summary and
the metrics as plain rows (a dict of column lists) where the JAX package
returns DataFrames. Plots go through matplotlib alone.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np

SUMMARY_COLUMNS = ("case", "delegate_type", "mean", "std")
METRIC_COLUMNS = ("precision", "recall", "f1-score", "support")


def find_result_csvs(results_dir: str | Path = "results") -> list[Path]:
    """All result_*.csv under the results root, sorted (41:13-16)."""
    return sorted(Path(results_dir).rglob("result_*.csv"))


def _fmt(x: float) -> str:
    return "" if math.isnan(x) else "%.4f" % x


def _read_results(path: Path) -> list[dict]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        r["similarity_score"] = float(r["similarity_score"])
    return rows


def _groups(rows: list[dict]) -> dict[tuple[str, str], list[dict]]:
    """Rows by (case, delegate_type), in sorted key order (groupby)."""
    out: dict[tuple[str, str], list[dict]] = {}
    for r in rows:
        out.setdefault((r["case"], r["delegate_type"]), []).append(r)
    return dict(sorted(out.items()))


def _mean_std(x: list[float]) -> tuple[float, float]:
    n = len(x)
    mean = math.fsum(x) / n
    if n < 2:
        return mean, math.nan
    return mean, math.sqrt(math.fsum((v - mean) ** 2 for v in x) / (n - 1))


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """sklearn's ``_prf_divide`` with zero_division=0."""
    den = den.astype(np.float64)
    zero = den == 0
    den[zero] = 1
    out = num / den
    out[zero] = 0.0
    return out


def classification_report(y_true: list[str], y_pred: list[str],
                          labels: list[str]) -> list[tuple[str, list]]:
    """sklearn's ``classification_report(y_true, y_pred, labels=labels,
    output_dict=True, zero_division=0)`` as rows (name, [precision,
    recall, f1-score, support]) in pandas' transposed order. ``labels``
    covers every true and predicted class, so the micro average is the
    ``accuracy`` row."""
    pos = {c: i for i, c in enumerate(labels)}
    t = np.array([pos[c] for c in y_true], np.int64)
    p = np.array([pos[c] for c in y_pred], np.int64)
    k = len(labels)
    tp = np.bincount(t[t == p], minlength=k)
    true_sum = np.bincount(t, minlength=k)
    pred_sum = np.bincount(p, minlength=k)

    def prf(tp, true_sum, pred_sum):
        return (_divide(tp, pred_sum), _divide(tp, true_sum),
                _divide(2.0 * tp, 1.0 * true_sum + pred_sum))

    precision, recall, f1 = prf(tp, true_sum, pred_sum)
    rows = [(c, [float(precision[i]), float(recall[i]), float(f1[i]),
                 float(true_sum[i])]) for i, c in enumerate(labels)]
    micro = prf(np.array([tp.sum()]), np.array([true_sum.sum()]),
                np.array([pred_sum.sum()]))
    support = float(np.sum(true_sum))
    acc = float(micro[0][0])
    rows.append(("accuracy", [acc, acc, acc, acc]))
    rows.append(("macro avg", [float(np.average(m))
                               for m in (precision, recall, f1)] + [support]))
    rows.append(("weighted avg", [float(np.average(m, weights=true_sum))
                                  for m in (precision, recall, f1)]
                 + [support]))
    return rows


def confusion_matrix(y_true: list[str], y_pred: list[str],
                     labels: list[str]) -> np.ndarray:
    """[K, K] counts, rows true and columns predicted, in ``labels``
    order."""
    pos = {c: i for i, c in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for a, b in zip(y_true, y_pred):
        cm[pos[a], pos[b]] += 1
    return cm


def analyze(result_csv: str | Path, make_plots: bool = True) -> dict:
    """Run the full analysis; returns {summary, summary_path, metrics,
    plots}, the summary and each group's metrics as a dict of column
    lists. ``make_plots=True`` needs matplotlib and raises ImportError
    naming it when it is missing."""
    if make_plots:
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError(
                "analyze(make_plots=True) needs matplotlib, which is not "
                "installed; pass make_plots=False for the CSVs alone"
            ) from e
    result_csv = Path(result_csv)
    rows = _read_results(result_csv)
    out_dir = result_csv.parent
    img_dir = out_dir / "img"
    metrics_dir = out_dir / "metrics"
    groups = _groups(rows)

    # [0] similarity summary
    summary: dict[str, list] = {c: [] for c in SUMMARY_COLUMNS}
    for (case, dtype), g in groups.items():
        mean, std = _mean_std([r["similarity_score"] for r in g])
        for col, v in zip(SUMMARY_COLUMNS, (case, dtype, mean, std)):
            summary[col].append(v)
    summary_path = out_dir / "similarity_score_summary.csv"
    with open(summary_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(SUMMARY_COLUMNS)
        for case, dtype, mean, std in zip(*summary.values()):
            w.writerow([case, dtype, _fmt(mean), _fmt(std)])

    # Union of true AND predicted classes: in nearest mode a prediction
    # can name a class absent from the test set, and must appear in the
    # report, not vanish.
    class_list = sorted({r["true_class"] for r in rows}
                        | {r["predicted_class"] for r in rows})
    metrics: dict[tuple[str, str], dict[str, list]] = {}
    metrics_dir.mkdir(parents=True, exist_ok=True)
    for (case, dtype), g in groups.items():
        report = classification_report(
            [r["true_class"] for r in g], [r["predicted_class"] for r in g],
            class_list)
        table: dict[str, list] = {"label": [], "case": [],
                                  "delegate_type": []}
        table.update({c: [] for c in METRIC_COLUMNS})
        with open(metrics_dir / f"metrics_{case}_{dtype}.csv", "w",
                  newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["", "case", "delegate_type", *METRIC_COLUMNS])
            for name, vals in report:
                w.writerow([name, case, dtype, *map(_fmt, vals)])
                for col, v in zip(table, (name, case, dtype, *vals)):
                    table[col].append(v)
        metrics[(case, dtype)] = table

    plot_paths: list[Path] = []
    if make_plots:
        plot_paths = _plots(matplotlib, rows, groups, class_list, out_dir,
                            img_dir)
    return {
        "summary": summary,
        "summary_path": summary_path,
        "metrics": metrics,
        "plots": plot_paths,
    }


def _plots(matplotlib, rows, groups, class_list, out_dir: Path,
           img_dir: Path) -> list[Path]:
    """The reference's three plot kinds, through matplotlib alone."""
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img_dir.mkdir(parents=True, exist_ok=True)
    paths: list[Path] = []

    # [1] confusion matrices
    for (case, dtype), g in groups.items():
        cm = confusion_matrix([r["true_class"] for r in g],
                              [r["predicted_class"] for r in g], class_list)
        fig, ax = plt.subplots(
            figsize=(max(4, len(class_list)), max(3, len(class_list))))
        im = ax.imshow(cm, cmap="Blues")
        ax.set_xticks(range(len(class_list)))
        ax.set_yticks(range(len(class_list)))
        ax.set_xticklabels(class_list, rotation=45, ha="right")
        ax.set_yticklabels(class_list)
        for r in range(cm.shape[0]):
            for c in range(cm.shape[1]):
                ax.text(c, r, str(cm[r, c]), ha="center", va="center",
                        color="black" if cm[r, c] < cm.max() / 2 else "white")
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title(f"Confusion Matrix\n{case.upper()} - {dtype}")
        fig.colorbar(im)
        fig.tight_layout()
        p = img_dir / f"cm_{case}_{dtype}.png"
        fig.savefig(p)
        plt.close(fig)
        paths.append(p)

    # [2] score distribution boxplot: one box per (delegate_type, case)
    dtypes = list(dict.fromkeys(r["delegate_type"] for r in rows))
    cases = list(dict.fromkeys(r["case"] for r in rows))
    fig, ax = plt.subplots(figsize=(12, 6))
    width = 0.8 / max(1, len(cases))
    for j, case in enumerate(cases):
        data = [[r["similarity_score"] for r in groups.get((case, d), [])]
                for d in dtypes]
        pos = [i - 0.4 + width * (j + 0.5) for i in range(len(dtypes))]
        keep = [(x, p) for x, p in zip(data, pos) if x]
        if keep:
            bp = ax.boxplot([x for x, _ in keep],
                            positions=[p for _, p in keep], widths=width,
                            patch_artist=True)
            color = f"C{j}"
            for box in bp["boxes"]:
                box.set_facecolor(color)
            ax.plot([], [], color=color, linewidth=8, label=case)
    ax.set_xticks(range(len(dtypes)))
    ax.set_xticklabels(dtypes)
    ax.set_title("Similarity score distribution by delegate type")
    ax.set_ylabel("Cosine Similarity")
    ax.set_xlabel("Delegate Vector Type")
    ax.legend(title="Case")
    fig.tight_layout()
    p = img_dir / "similarity_score_distribution.png"
    fig.savefig(p)
    plt.close(fig)
    paths.append(p)

    # [4] per-experiment .npy histograms
    score_dir = out_dir / "score_distribution"
    if score_dir.exists():
        for npy_file in sorted(score_dir.glob("*.npy")):
            scores = np.load(npy_file)
            fig, ax = plt.subplots()
            ax.hist(scores, bins=20)
            ax.set_title(f"Score Distribution: {npy_file.stem}")
            ax.set_xlabel("Cosine Similarity")
            ax.set_ylabel("Frequency")
            fig.tight_layout()
            p = img_dir / f"{npy_file.stem}_hist.png"
            fig.savefig(p)
            plt.close(fig)
            paths.append(p)
    return paths
