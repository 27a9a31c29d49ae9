"""Bounding-box crop stage (the 21_* stage).

Reads YOLO-format labels next to each image, converts normalised
coordinates to pixels, applies the 20% margin rule clamped to image bounds
and writes one ``<stem>_cropped_obj<i><ext>`` file per box into
``dataset_cropped/{type}_images/<class>/`` — the exact filename and layout
contract of 21_crop_image.py:99-103, so artifacts remain interchangeable
with the reference tree.

The device-fused variant for serving (no filesystem round trip) is
``ops.image.crop_resize_batch``. Host code copied from the JAX package's
``pipelines/crop.py``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from retrieval_based_object_detection_tpu_torch.ops.image import expand_box_with_margin
from retrieval_based_object_detection_tpu_torch.utils import tree


@dataclasses.dataclass
class CropConfig:
    src_root: str = "dataset_jpeg"
    dst_root: str = "dataset_cropped"
    img_type: str = "original"
    classes: list[str] | None = None
    margin_ratio: float = 0.2  # 21_crop_image.py:9
    # 21 globs *.jpg only — which silently misses the .jpeg files the
    # ingest stage (01:85-86) produces; we accept both.
    suffixes: tuple[str, ...] = (".jpg", ".jpeg")


@dataclasses.dataclass
class CropResult:
    n_objects: int
    n_no_label: int
    n_empty_label: int


def parse_yolo_label_indexed(
    label_path: Path,
) -> tuple[list[tuple[int, tuple[int, float, float, float, float]]], int]:
    """YOLO lines: ``<cls> <xc> <yc> <w> <h>`` normalised. Returns
    ``([(line_idx, box), ...], n_nonblank_lines)`` where ``line_idx``
    is the box's position among NON-BLANK lines — malformed lines are
    skipped but keep their slot, because the reference numbers output
    crops by raw line position (21_crop_image.py:66-77: blank lines are
    filtered, then ``enumerate`` + ``continue``), and the
    ``_cropped_obj<i>`` filename index feeds MD5 point ids downstream —
    renumbering would break the byte-parity filename contract."""
    with open(label_path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    out = []
    for i, line in enumerate(lines):
        parts = line.split()
        if len(parts) != 5:
            continue
        cls, xc, yc, w, h = parts
        out.append((i, (int(float(cls)), float(xc), float(yc),
                        float(w), float(h))))
    return out, len(lines)


def parse_yolo_label(label_path: Path) -> list[tuple[int, float, float, float, float]]:
    """Parsed boxes only (malformed lines skipped, 21_crop_image.py:71-75);
    consumers that name outputs by line position must use
    :func:`parse_yolo_label_indexed`."""
    return [box for _, box in parse_yolo_label_indexed(label_path)[0]]


def yolo_to_xyxy(box, img_w: int, img_h: int) -> tuple[int, int, int, int]:
    """Normalised (xc, yc, w, h) → integer pixel xyxy (21:78-87)."""
    _, xc, yc, bw, bh = box
    xc, yc, bw, bh = xc * img_w, yc * img_h, bw * img_w, bh * img_h
    return (int(xc - bw / 2), int(yc - bh / 2),
            int(xc + bw / 2), int(yc + bh / 2))


def yolo_crop_bounds(box, img_w: int, img_h: int,
                     margin_ratio: float) -> tuple[int, int, int, int]:
    """Margin-expanded crop bounds for one YOLO box — the byte-parity
    crop rule (21_crop_image.py:78-95): margins come from the FLOAT
    pixel box dims (``int(bbox_w * ratio)``), NOT from the difference of
    the already-truncated corners, which is off by one pixel whenever
    truncation shrinks the width across the ``ratio·w`` integer
    boundary (e.g. w=14.9 → corners span 15 → margin 3 vs the
    reference's int(2.98)=2)."""
    _, xc, yc, bw, bh = box
    xc, yc, bw, bh = xc * img_w, yc * img_h, bw * img_w, bh * img_h
    x1, y1 = int(xc - bw / 2), int(yc - bh / 2)
    x2, y2 = int(xc + bw / 2), int(yc + bh / 2)
    mx, my = int(bw * margin_ratio), int(bh * margin_ratio)
    return (max(x1 - mx, 0), max(y1 - my, 0),
            min(x2 + mx, img_w), min(y2 + my, img_h))


def crop_image_with_labels(
    image: np.ndarray,  # [H, W, C]
    boxes_xyxy: list[tuple[int, int, int, int]],
    margin_ratio: float = 0.2,
) -> list[np.ndarray]:
    h, w = image.shape[:2]
    crops = []
    for box in boxes_xyxy:
        x1, y1, x2, y2 = expand_box_with_margin(box, w, h, margin_ratio)
        crops.append(image[y1:y2, x1:x2])
    return crops


def run_crop(cfg: CropConfig) -> CropResult:
    from PIL import Image

    n_obj = n_nolabel = n_empty = 0
    for cls in (cfg.classes if cfg.classes is not None
                else tree.list_classes(cfg.src_root, cfg.img_type)):
        dst_dir = tree.type_dir(cfg.dst_root, cfg.img_type) / cls
        dst_dir.mkdir(parents=True, exist_ok=True)
        for img_path in tree.list_images(cfg.src_root, cfg.img_type, cls,
                                         cfg.suffixes):
            label_path = img_path.with_suffix(".txt")
            if not label_path.exists():
                n_nolabel += 1
                continue
            labels, n_lines = parse_yolo_label_indexed(label_path)
            if n_lines == 0:
                # Empty == no non-blank lines (21:66-71); a file whose
                # lines are all malformed writes nothing but is not
                # counted as "no objects".
                n_empty += 1
                continue
            with Image.open(img_path) as im:
                arr = np.asarray(im.convert("RGB"))
            h, w = arr.shape[:2]
            ext = img_path.suffix.lower()
            for i, box in labels:
                x1, y1, x2, y2 = yolo_crop_bounds(box, w, h,
                                                  cfg.margin_ratio)
                Image.fromarray(arr[y1:y2, x1:x2]).save(
                    dst_dir / f"{img_path.stem}_cropped_obj{i}{ext}")
                n_obj += 1
    return CropResult(n_objects=n_obj, n_no_label=n_nolabel,
                      n_empty_label=n_empty)
