"""YOLOv8 checkpoint auto-download with local cache.

The reference expects the pretrained weights at ``model/yolov8s.pt``
(11_dataset_labeling.py:10) and ships no fetch step; this mirrors the
SAM auto-download convention (22_segment_image_auto.py:24-38) for the
official ultralytics release assets, caching into the same ``model/``
directory the reference reads — so a checkout with the reference's own
asset in place loads it without any network at all. Host code copied
from the JAX package's ``models/yolo/download.py``.
"""

from __future__ import annotations

from pathlib import Path

from retrieval_based_object_detection_tpu_torch.utils.download import (
    DownloadError,
    fetch_with_cache,
)

_ASSETS = "https://github.com/ultralytics/assets/releases/download/v8.2.0"
YOLO_CHECKPOINT_URLS: dict[str, str] = {
    v: f"{_ASSETS}/{v}.pt"
    for v in ("yolov8n", "yolov8s", "yolov8m", "yolov8l", "yolov8x")
}

DEFAULT_CACHE_DIR = "model"  # the reference's checkpoint dir (11:10)


class CheckpointUnavailable(RuntimeError):
    """Raised when the checkpoint is absent and cannot be downloaded."""


def checkpoint_path(variant: str = "yolov8s",
                    cache_dir: str | Path = DEFAULT_CACHE_DIR) -> Path:
    return Path(cache_dir) / f"{variant}.pt"


def ensure_checkpoint(variant: str = "yolov8s",
                      cache_dir: str | Path = DEFAULT_CACHE_DIR,
                      quiet: bool = False) -> Path:
    """Local path of the YOLOv8 checkpoint, downloading into
    ``cache_dir`` if missing. Raises CheckpointUnavailable with a remedy
    when offline."""
    if variant not in YOLO_CHECKPOINT_URLS:
        raise KeyError(
            f"unknown YOLO variant {variant!r}; "
            f"expected one of {sorted(YOLO_CHECKPOINT_URLS)}")
    dest = checkpoint_path(variant, cache_dir)
    url = YOLO_CHECKPOINT_URLS[variant]
    try:
        return fetch_with_cache(url, dest, quiet=quiet,
                                label=f"YOLOv8 {variant} checkpoint")
    except DownloadError as e:
        raise CheckpointUnavailable(
            f"{variant} checkpoint is not cached at {dest} and the "
            f"download from {url} failed ({e}). Either place the official "
            f".pt there manually (the reference keeps it at "
            f"model/yolov8s.pt), pass --detector-checkpoint <path>, or "
            f"run once with network access."
        ) from e
