"""Deterministic content-addressed point IDs.

MD5 of the resolved image path for raw crop vectors
(31_clip_embedding_and_save_vector.py:42-43) and MD5 of
``class::delegate_type::data_type::is_segmented::is_augmented`` for delegate
vectors (32_create_delegate_vector.py:29-31). The key construction is the
reference's, so re-runs overwrite rather than duplicate and IDs are
interchangeable with those of the JAX package.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Mapping


def point_id_from_path(img_path: str | Path) -> str:
    """MD5 of the resolved absolute image path (hex digest)."""
    return hashlib.md5(str(Path(img_path).resolve()).encode()).hexdigest()


def delegate_id(payload: Mapping[str, object], delegate_type: str) -> str:
    """MD5 of the delegate identity key, with Python ``str()`` of the
    boolean flags (32_create_delegate_vector.py:29-31)."""
    key = (
        f"{payload.get('class_name')}::{delegate_type}::{payload.get('data_type')}"
        f"::{payload.get('is_segmented')}::{payload.get('is_augmented')}"
    )
    return hashlib.md5(key.encode()).hexdigest()
