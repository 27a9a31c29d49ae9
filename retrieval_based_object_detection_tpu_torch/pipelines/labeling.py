"""Auto-labeling stage (the 11_* stage).

Contract from 11_dataset_labeling.py:
  * class-id map = sorted directory names over ALL classes (11:104-106)
  * ``classes.txt`` written at the dataset root + optional per-dir copies
    (11:108-126)
  * per image: detect → keep top-K boxes by confidence (11:175-180) →
    write normalised YOLO label lines ``<cls> <xc> <yc> <w> <h>`` with 6
    decimals (11:182-189)
  * skip existing labels unless ``overwrite`` (11:145-147)
  * summary counters: total/labeled/skipped-existing/no-object/failed +
    the not-detected list (11:131-136, 196-211)

The detector is pluggable: any callable images[B,H,W,3] → (boxes[B,K,4]
xyxy px, scores[B,K]), numpy in and out. It defaults to the weight-free
``SaliencyProposer`` on ``device``; images are letterbox-resized to a
fixed square so detection runs in fixed-shape device batches instead of
the reference's per-image predict loop. Host code copied from the JAX
package's ``pipelines/labeling.py``.
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.utils import tree


@dataclasses.dataclass
class LabelConfig:
    root_dir: str = "dataset_jpeg"
    img_type: str = "original"
    classes: list[str] | None = None  # None = all (class ids still global)
    conf_threshold: float = 0.25  # 11:159
    max_object_count: int | None = 1  # top-K by confidence (11:175-180)
    overwrite: bool = False
    per_dir_classes_txt: bool = True
    batch_size: int = 16
    det_size: int = 256  # square letterbox size fed to the detector
    suffixes: tuple[str, ...] = (".jpg", ".jpeg", ".png")


@dataclasses.dataclass
class LabelResult:
    total_images: int = 0
    labeled: int = 0
    skipped_existing: int = 0
    skipped_no_object: int = 0
    failed: int = 0
    not_detected: list[str] = dataclasses.field(default_factory=list)


def write_classes_txt(root_dir: str | Path, img_type: str,
                      per_dir: bool = True) -> list[str]:
    """classes.txt with sorted class names; optional per-class-dir copies."""
    base = tree.type_dir(root_dir, img_type)
    if not base.is_dir():
        raise FileNotFoundError(
            f"dataset tree not found: {base} — run the ingest stage first "
            f"or check --root/--type")
    classes = tree.list_classes(root_dir, img_type)
    classes_txt = base / "classes.txt"
    classes_txt.write_text("".join(f"{c}\n" for c in classes))
    if per_dir:
        for c in classes:
            shutil.copy(classes_txt, base / c / "classes.txt")
    return classes


def letterbox(img: np.ndarray, size: int) -> tuple[np.ndarray, float]:
    """Scale the longer side to ``size`` on a square canvas padded with the
    image's median border colour (black padding would read as a salient
    region to the background-contrast detector).
    Returns (canvas, scale) with boxes mapping back as box/scale."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    resized = np.asarray(
        Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    border = np.concatenate([
        img[0, :, :], img[-1, :, :], img[:, 0, :], img[:, -1, :]
    ])
    fill = np.median(border, axis=0).astype(img.dtype)
    canvas = np.broadcast_to(fill, (size, size, 3)).copy()
    canvas[:nh, :nw] = resized
    return canvas, scale


def yolo_lines(class_id: int, boxes_xyxy: np.ndarray,
               img_w: int, img_h: int) -> str:
    """Normalised YOLO label lines, 6 decimals (11:182-189)."""
    lines = []
    for x1, y1, x2, y2 in boxes_xyxy:
        xc = ((x1 + x2) / 2) / img_w
        yc = ((y1 + y2) / 2) / img_h
        bw = (x2 - x1) / img_w
        bh = (y2 - y1) / img_h
        lines.append(f"{class_id} {xc:.6f} {yc:.6f} {bw:.6f} {bh:.6f}\n")
    return "".join(lines)


def run_labeling(
    cfg: LabelConfig,
    detector: Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]] | None = None,
    device: str | torch.device = "cuda",
) -> LabelResult:
    """Label every image of the tree. ``device`` places the default
    ``SaliencyProposer``; a detector passed in runs where it was built."""
    from PIL import Image

    if detector is None:
        from retrieval_based_object_detection_tpu_torch.models.detector.saliency import (  # noqa: E501
            SaliencyProposer,
        )

        detector = SaliencyProposer(device=device)

    all_classes = write_classes_txt(cfg.root_dir, cfg.img_type,
                                    cfg.per_dir_classes_txt)
    class_to_id = {c: i for i, c in enumerate(all_classes)}
    process = cfg.classes if cfg.classes is not None else all_classes

    res = LabelResult()
    pending: list[tuple[Path, int, int, int, float, np.ndarray]] = []
    # (img_path, class_id, W, H, scale, canvas)

    def flush() -> None:
        if not pending:
            return
        batch = np.stack([p[5] for p in pending])
        boxes_b, scores_b = detector(batch)
        for (img_path, class_id, w, h, scale, _), boxes, scores in zip(
                pending, boxes_b, scores_b):
            order = np.argsort(-scores)
            boxes, scores = boxes[order], scores[order]
            keep = scores >= cfg.conf_threshold
            boxes, scores = boxes[keep], scores[keep]
            if cfg.max_object_count is not None:
                boxes = boxes[: cfg.max_object_count]
            if boxes.shape[0] == 0:
                res.skipped_no_object += 1
                res.not_detected.append(str(img_path))
                continue
            unscaled = np.clip(boxes / scale, 0,
                               [w, h, w, h]).astype(np.float64)
            img_path.with_suffix(".txt").write_text(
                yolo_lines(class_id, unscaled, w, h))
            res.labeled += 1
        pending.clear()

    for cls in process:
        class_id = class_to_id[cls]
        for img_path in tree.list_images(cfg.root_dir, cfg.img_type, cls,
                                         cfg.suffixes):
            res.total_images += 1
            label = img_path.with_suffix(".txt")
            if label.exists() and not cfg.overwrite:
                res.skipped_existing += 1
                continue
            try:
                with Image.open(img_path) as im:
                    arr = np.asarray(im.convert("RGB"))
            except Exception:
                res.failed += 1
                continue
            canvas, scale = letterbox(arr, cfg.det_size)
            pending.append((img_path, class_id, arr.shape[1], arr.shape[0],
                            scale, canvas))
            if len(pending) == cfg.batch_size:
                flush()
    flush()
    return res
