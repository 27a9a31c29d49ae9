"""Experiment grid runner (the 33_* stage, batched on device).

Reproduces the reference experiment semantics (33_run_all_experiments.py):
3 preprocessing cases × 4 delegate types over the natural test images of a
test group, scoring each test vector against its class delegate by cosine
similarity, then writing

  results/<YYYY-MM-DD>-<n>/result_<YYYY-MM-DD>-<n>.csv        (per-image rows)
  results/<YYYY-MM-DD>-<n>/score_distribution/<exp>_scores.npy

with identical schemas and row ordering (case → class → image → dtype,
33:87-165) and the collision-free numbered result dir (33:64-74).

Instead of 4 HTTP scrolls + a host dot product per test image (33:96-150),
all test vectors of a case form one [N, D] matrix and all delegates a
[C, D] matrix — similarity is a single normalised f32 matmul per (case,
delegate_type), on the gallery's device.

Two match modes:
  * ``same_class`` — parity with the reference as written: each test image
    is scored only against its own class's delegate (33:117-121), so
    predicted == true by construction.
  * ``nearest``    — the N-way generalisation: predicted class is the
    argmax over every class's delegate of that (case, dtype).
"""

from __future__ import annotations

import dataclasses
import datetime
from pathlib import Path

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.gallery.schema import (
    DELEGATE_TYPES,
    Filter,
)
from retrieval_based_object_detection_tpu_torch.gallery.store import Gallery
from retrieval_based_object_detection_tpu_torch.utils import tree

TEST_GROUPS = {
    "TestGroup1": "dataset_segmented",
    "TestGroup2": "dataset_cropped",
}


@dataclasses.dataclass
class ExperimentConfig:
    root_dir: str  # test-group root (dataset_segmented | dataset_cropped)
    results_dir: str = "results"
    cases: tuple[str, ...] = ("pre_a", "pre_b", "pre_c")
    delegate_types: tuple[str, ...] = DELEGATE_TYPES
    match_mode: str = "same_class"  # "same_class" | "nearest"
    # The reference globs only *.png (33:94) — which misses its own crop
    # stage's .jpg outputs and makes TestGroup2 empty; we accept all three.
    test_suffixes: tuple[str, ...] = (".png", ".jpg", ".jpeg")


@dataclasses.dataclass
class ResultRow:
    experiment_id: str
    case: str
    delegate_type: str
    image_path: str
    true_class: str
    predicted_class: str
    similarity_score: float


@dataclasses.dataclass
class ExperimentOutput:
    rows: list[ResultRow]
    scores: dict[str, list[float]]  # "<case>_<dtype>" -> scores
    class_image_count: dict[str, int]
    csv_path: Path | None = None


def allocate_result_dir(results_dir: str | Path,
                        today: str | None = None) -> tuple[Path, Path]:
    """Collision-free ``<date>-<n>`` result dir + csv path (33:64-74)."""
    today = today or datetime.datetime.now().strftime("%Y-%m-%d")
    count = 1
    results_dir = Path(results_dir)
    while True:
        subdir = results_dir / f"{today}-{count}"
        csv_path = subdir / f"result_{today}-{count}.csv"
        if not csv_path.exists():
            subdir.mkdir(parents=True, exist_ok=True)
            return subdir, csv_path
        count += 1


def _cosine_matrix(tests: np.ndarray, delegates: np.ndarray,
                   device: torch.device) -> np.ndarray:
    """[N, D] x [C, D] -> [N, C] cosine similarities in full f32, the
    counterpart of JAX's HIGHEST precision. Expects TF32 off for matmuls
    (PyTorch's default), as ``ops.medoid`` does."""
    def norm(x):
        x = torch.from_numpy(np.asarray(x, np.float32)).to(device)
        return x / torch.clamp(
            torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)), min=1e-12)
    return (norm(tests) @ norm(delegates).T).cpu().numpy()


def _delegate_filter(case: str, dtype: str, data_type: str) -> Filter:
    """The delegate lookup filter of 33:117-137 minus the class pin."""
    return (
        Filter(must={
            "delegate_type": dtype,
            "is_delegate": True,
            "data_type": data_type,
        })
        & Filter.for_case(case)
    )


def run_experiments(
    gallery: Gallery,
    cfg: ExperimentConfig,
    write_outputs: bool = True,
) -> ExperimentOutput:
    rows: list[ResultRow] = []
    scores: dict[str, list[float]] = {}
    class_image_count: dict[str, int] = {}

    # Enumerate test images from the FILESYSTEM (classes and files), vectors
    # from the gallery — exactly the reference's split (33:89-110).
    classes = tree.list_classes(cfg.root_dir, "natural")

    # Gather test vectors ONCE (the lookup does not depend on the case;
    # the per-case bookkeeping below still runs per case). Exact-path
    # lookups fall back to resolved paths in the store; files with no
    # stored vector are counted and surfaced, never silently dropped.
    test_vecs: list[np.ndarray] = []
    test_meta: list[tuple[str, str, str]] = []  # (path, class, data_type)
    n_unembedded = 0
    for cls in classes:
        for img in tree.list_images(cfg.root_dir, "natural", cls,
                                    cfg.test_suffixes):
            rec = gallery.get_by_path(str(img))
            if rec is None:
                n_unembedded += 1
                continue
            if rec.payload.is_delegate:
                continue
            test_vecs.append(rec.vector)
            test_meta.append((str(img), cls, rec.payload.data_type))
    if n_unembedded:
        print(f"[experiments] WARNING: {n_unembedded} test image(s) have "
              f"no stored vector in collection {gallery.name!r} — run the "
              f"embed stage over the same tree first")
    if not test_vecs and n_unembedded:
        raise ValueError(
            f"none of the {n_unembedded} test images under "
            f"{cfg.root_dir}/natural_images have vectors in "
            f"{gallery.name!r} — the embed and experiment runs must "
            f"target the same collection and tree")

    # One stack for every case: the test matrix never changes across
    # the case loop (and _cosine_matrix renormalises it per call).
    tests = np.stack(test_vecs) if test_vecs else None
    for case in cfg.cases:
        if tests is None:
            continue

        # Delegate matrices per dtype for this case, over ALL classes.
        for_case: dict[str, tuple[np.ndarray, list[str], dict[str, int]]] = {}
        data_type = test_meta[0][2]
        for dtype in cfg.delegate_types:
            flt = _delegate_filter(case, dtype, data_type)
            recs = gallery.scroll_all(flt, with_vectors=True)
            if not recs:
                continue
            dvecs = np.stack([r.vector for r in recs])
            dclasses = [r.payload.class_name for r in recs]
            for_case[dtype] = (
                dvecs, dclasses,
                {c: i for i, c in enumerate(dclasses)},
            )

        # One [N, C] matmul per (case, dtype).
        sims: dict[str, np.ndarray] = {
            dtype: _cosine_matrix(tests, dvecs, gallery.device)
            for dtype, (dvecs, _, _) in for_case.items()
        }

        for i, (img_path, cls, _) in enumerate(test_meta):
            # The reference counts each test image once per case loop
            # (33:104-111) — i.e. once per case in which it has a vector.
            class_image_count[cls] = class_image_count.get(cls, 0) + 1
            for dtype in cfg.delegate_types:
                if dtype not in for_case:
                    continue
                dvecs, dclasses, cls_index = for_case[dtype]
                if cfg.match_mode == "same_class":
                    if cls not in cls_index:
                        continue
                    j = cls_index[cls]
                else:
                    j = int(np.argmax(sims[dtype][i]))
                score = float(sims[dtype][i, j])
                key = f"{case}_{dtype}"
                rows.append(ResultRow(
                    experiment_id=key,
                    case=case,
                    delegate_type=dtype,
                    image_path=img_path,
                    true_class=cls,
                    predicted_class=dclasses[j],
                    similarity_score=score,
                ))
                scores.setdefault(key, []).append(score)

    out = ExperimentOutput(rows=rows, scores=scores,
                           class_image_count=class_image_count)
    if write_outputs:
        out.csv_path = write_results(out, cfg.results_dir)
    return out


def write_results(out: ExperimentOutput,
                  results_dir: str | Path) -> Path:
    """CSV + per-experiment .npy score arrays (33:167-197)."""
    import csv

    _, csv_path = allocate_result_dir(results_dir)
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=[
            "experiment_id", "case", "delegate_type", "image_path",
            "true_class", "predicted_class", "similarity_score"])
        writer.writeheader()
        for r in out.rows:
            writer.writerow(dataclasses.asdict(r))

    score_dir = csv_path.parent / "score_distribution"
    score_dir.mkdir(parents=True, exist_ok=True)
    for key, vals in sorted(out.scores.items()):
        np.save(score_dir / f"{key}_scores.npy", np.asarray(vals))
    return csv_path
