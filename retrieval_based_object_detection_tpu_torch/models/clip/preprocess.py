"""CLIP image normalisation constants and batch padding.

The reference normalises with CLIP's mean/std after ToTensor
(31_clip_embedding_and_save_vector.py:32-33). The bicubic resize paths of
the JAX package (``preprocess_pil``, ``preprocess_batch``) are not ported
yet.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def pad_batch(arrs: list[np.ndarray], batch_size: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of preprocessed images to a fixed batch.

    Returns (batch [batch_size, ...], valid mask [batch_size])."""
    if not arrs or len(arrs) > batch_size:
        raise ValueError(f"need 1..{batch_size} images, got {len(arrs)}")
    out = np.zeros((batch_size,) + arrs[0].shape, np.float32)
    valid = np.zeros(batch_size, bool)
    for i, a in enumerate(arrs):
        out[i] = a
        valid[i] = True
    return out, valid
