"""Segmentation stage: auto (22a) + manual click session (22m).

Auto contract (22_segment_image_auto.py:115-159): per image, prompt the
predictor with the single center point, ``multimask_output=True``, pick the
best of 3 masks by predicted score, write the original RGB with the mask
in the alpha channel to ``dataset_segmented/{type}_images/<class>/
<stem>.png``.

Manual contract (22_segment_image_manual.py): a session over one class
directory; ``load`` lists all or only-unprocessed images (stem-diff against
``*_rmbg.png`` outputs, 22m:76-84), ``click(x, y)`` returns 3 candidate
masks, ``save(mask_idx)`` writes ``<stem>_rmbg.png``. The session is
UI-agnostic. Host-only code, copied from the JAX package's
``pipelines/segment.py``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from retrieval_based_object_detection_tpu_torch.utils import tree


@dataclasses.dataclass
class SegmentConfig:
    src_root: str = "dataset_cropped"
    dst_root: str = "dataset_segmented"
    img_type: str = "original"
    classes: list[str] | None = None
    suffixes: tuple[str, ...] = (".jpg", ".jpeg", ".png")


@dataclasses.dataclass
class SegmentResult:
    n_segmented: int
    n_failed: int


def apply_mask_rgba(img_rgb: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Original RGB + mask as alpha (22a:154-156)."""
    rgba = np.concatenate([
        img_rgb,
        (mask.astype(np.uint8) * 255)[..., None],
    ], axis=-1)
    return rgba


def run_auto_segment(cfg: SegmentConfig, predictor,
                     batch_size: int = 8) -> SegmentResult:
    """``predictor`` is any object with set_image/predict. When it also
    exposes ``segment_batch`` (the port's SamPredictor), images stream
    through the encoder in fixed-size batches — one encoder call per batch
    instead of per image — with the tail chunk padded to the batch size by
    repeating its last image."""
    from PIL import Image

    n_ok = n_fail = 0
    classes = (cfg.classes if cfg.classes is not None
               else tree.list_classes(cfg.src_root, cfg.img_type))
    work: list[tuple] = []  # (img_path, dst_path)
    for cls in classes:
        dst_dir = tree.type_dir(cfg.dst_root, cfg.img_type) / cls
        dst_dir.mkdir(parents=True, exist_ok=True)
        for img_path in tree.list_images(cfg.src_root, cfg.img_type, cls,
                                         cfg.suffixes):
            work.append((img_path, dst_dir / f"{img_path.stem}.png"))

    if not hasattr(predictor, "segment_batch"):
        for img_path, dst in work:
            try:
                with Image.open(img_path) as im:
                    rgb = np.asarray(im.convert("RGB"))
                h, w = rgb.shape[:2]
                predictor.set_image(rgb)
                masks, scores = predictor.predict(
                    point_coords=np.array([[w / 2, h / 2]]),
                    point_labels=np.array([1]),
                    multimask_output=True,
                )
                best = masks[int(np.argmax(scores))]
                Image.fromarray(apply_mask_rgba(rgb, best)).save(dst)
                n_ok += 1
            except Exception:
                n_fail += 1
        return SegmentResult(n_segmented=n_ok, n_failed=n_fail)

    for start in range(0, len(work), batch_size):
        chunk = work[start:start + batch_size]
        rgbs, dsts = [], []
        for img_path, dst in chunk:
            try:
                with Image.open(img_path) as im:
                    rgbs.append(np.asarray(im.convert("RGB")))
                dsts.append(dst)
            except Exception:
                n_fail += 1
        if not rgbs:
            continue
        real = len(rgbs)
        # Pad the tail with a repeat of the last image: every encoder call
        # takes one batch shape.
        padded = rgbs + [rgbs[-1]] * (batch_size - real)
        try:
            results = predictor.segment_batch(padded)[:real]
        except Exception:
            n_fail += real
            continue
        for rgb, dst, (masks, scores) in zip(rgbs, dsts, results):
            try:
                best = masks[int(np.argmax(scores))]
                Image.fromarray(apply_mask_rgba(rgb, best)).save(dst)
                n_ok += 1
            except Exception:
                n_fail += 1
    return SegmentResult(n_segmented=n_ok, n_failed=n_fail)


class ManualSegmentSession:
    """Click-to-segment session over one class directory (22m's state)."""

    def __init__(self, predictor, src_dir: str | Path,
                 only_unprocessed: bool = True):
        self.predictor = predictor
        self.src_dir = Path(src_dir)
        self.items = self._list(only_unprocessed)
        self.pos = 0
        self._loaded: np.ndarray | None = None
        self._candidates: np.ndarray | None = None
        self._scores: np.ndarray | None = None

    def _list(self, only_unprocessed: bool) -> list[Path]:
        imgs = sorted(
            p for p in self.src_dir.iterdir()
            if p.suffix.lower() in (".jpg", ".jpeg", ".png")
            and not p.stem.endswith("_rmbg")
        )
        if only_unprocessed:
            done = {p.stem[: -len("_rmbg")]
                    for p in self.src_dir.glob("*_rmbg.png")}
            imgs = [p for p in imgs if p.stem not in done]
        return imgs

    @property
    def current(self) -> Path | None:
        return self.items[self.pos] if self.pos < len(self.items) else None

    def load(self) -> np.ndarray:
        """Load the current image and run the encoder (expensive, once)."""
        from PIL import Image

        if self.current is None:
            raise RuntimeError("no images left in this session")
        with Image.open(self.current) as im:
            self._loaded = np.asarray(im.convert("RGB"))
        self.predictor.set_image(self._loaded)
        return self._loaded

    def click(self, x: float, y: float) -> tuple[np.ndarray, np.ndarray]:
        """Point prompt → (3 candidate masks, scores) (22m:152-205)."""
        if self._loaded is None:
            raise RuntimeError("load() first")
        masks, scores = self.predictor.predict(
            point_coords=np.array([[x, y]]),
            point_labels=np.array([1]),
            multimask_output=True,
        )
        self._candidates, self._scores = masks, scores
        return masks, scores

    def save(self, mask_idx: int) -> Path:
        """Write ``<stem>_rmbg.png`` with the chosen mask (22m:249-282)."""
        from PIL import Image

        if self._candidates is None:
            raise RuntimeError("click() first")
        out = self.src_dir / f"{self.current.stem}_rmbg.png"
        rgba = apply_mask_rgba(self._loaded, self._candidates[mask_idx])
        Image.fromarray(rgba).save(out)
        return out

    def next(self) -> None:
        self.pos += 1
        self._loaded = self._candidates = self._scores = None
