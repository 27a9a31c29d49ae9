"""HEIC→JPEG ingest stage (the 01_* stage).

Behavioral contract from 01_heic_to_jpeg.py:
  * walks ``dataset_heic/{original|natural}_images/<class>/*.HEIC`` and
    writes ``dataset_jpeg/.../<stem>.jpeg`` (01:30-31, 85-86, 143)
  * skips duplicate-pattern files ``*(N)*`` (01:33-35, 138-140)
  * idempotent: skips files whose output already exists (01:143-145)
  * per-item failures are logged and skipped (01:147-152)

HEIC decoding needs pillow-heif, which is not in this image — the decoder
is resolved lazily and a clear error raised only when an actual .heic file
must be decoded. Every other format PIL can open is converted through the
same path, so the stage is testable (and useful) without HEIC support.
Host code copied from the JAX package's ``pipelines/ingest.py``.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from retrieval_based_object_detection_tpu_torch.utils import tree

_DUP_PATTERN = re.compile(r"\(\d+\)")  # "IMG_0001 (2).HEIC" style duplicates

_heif_registered: bool | None = None


def _ensure_heif() -> bool:
    """Register the pillow-heif opener with PIL if available (lazy)."""
    global _heif_registered
    if _heif_registered is None:
        try:
            from pillow_heif import register_heif_opener

            register_heif_opener()
            _heif_registered = True
        except ImportError:
            _heif_registered = False
    return _heif_registered


def is_duplicate_name(name: str) -> bool:
    """True for the ``(N)`` camera-duplicate pattern the reference skips."""
    return bool(_DUP_PATTERN.search(name))


@dataclasses.dataclass
class IngestConfig:
    src_root: str = "dataset_heic"
    dst_root: str = "dataset_jpeg"
    img_type: str = "original"
    classes: list[str] | None = None
    quality: int = 95
    suffixes: tuple[str, ...] = (".heic", ".png", ".jpg", ".jpeg", ".webp",
                                 ".bmp", ".tiff")


@dataclasses.dataclass
class IngestResult:
    n_converted: int
    n_skipped_existing: int
    n_skipped_duplicate: int
    n_failed: int
    # Two sources mapping to the same <stem>.jpeg this run (e.g. both
    # IMG_1.png and IMG_1.heic) — the loser is reported here, not
    # miscounted as already-converted.
    n_name_collisions: int = 0


def convert_one(src: Path, dst: Path, quality: int = 95) -> bool:
    """Convert a single image to JPEG; returns False on failure."""
    from PIL import Image

    if src.suffix.lower() in (".heic", ".heif") and not _ensure_heif():
        raise RuntimeError(
            "HEIC decoding requires pillow-heif, which is not installed in "
            "this environment")
    try:
        with Image.open(src) as im:
            im.convert("RGB").save(dst, "JPEG", quality=quality)
        return True
    except Exception as e:
        # Per-item failures are logged and skipped (01:147-152) — a
        # bare counter leaves the operator unable to tell WHICH of
        # thousands of inputs failed, or why.
        print(f"[ingest] FAILED {src}: {type(e).__name__}: {e}")
        return False


def run_ingest(cfg: IngestConfig) -> IngestResult:
    n_conv = n_exist = n_dup = n_fail = n_coll = 0
    classes = (cfg.classes if cfg.classes is not None
               else tree.list_classes(cfg.src_root, cfg.img_type))
    for cls in classes:
        dst_dir = tree.type_dir(cfg.dst_root, cfg.img_type) / cls
        dst_dir.mkdir(parents=True, exist_ok=True)
        written: dict[Path, Path] = {}  # dst -> src converted THIS run
        for src in tree.list_images(cfg.src_root, cfg.img_type, cls,
                                    cfg.suffixes):
            if is_duplicate_name(src.name):
                n_dup += 1
                continue
            dst = dst_dir / f"{src.stem}.jpeg"
            if dst in written:
                # Same stem, different suffix (possible since the suffix
                # list widened past the reference's .HEIC) — the second
                # source would silently vanish behind the idempotency
                # check; surface it instead.
                print(f"[ingest] WARNING: {src.name} collides with "
                      f"{written[dst].name} on {dst.name} — skipped")
                n_coll += 1
                continue
            if dst.exists():
                n_exist += 1
                continue
            if convert_one(src, dst, cfg.quality):
                written[dst] = src
                n_conv += 1
            else:
                n_fail += 1
    return IngestResult(n_converted=n_conv, n_skipped_existing=n_exist,
                        n_skipped_duplicate=n_dup, n_failed=n_fail,
                        n_name_collisions=n_coll)
