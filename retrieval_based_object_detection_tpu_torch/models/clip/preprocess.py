"""CLIP image preprocessing: the host PIL path, the device batch path, and
batch padding.

The reference preprocesses with the torchvision Compose returned by
``clip.load`` — Resize(224, bicubic) → CenterCrop(224) → ToTensor →
Normalize — one image at a time on the host
(31_clip_embedding_and_save_vector.py:32-33). ``preprocess_pil`` is that
pipeline through PIL, byte for byte the JAX package's. RGBA inputs
(segmented PNGs) are reduced with ``convert("RGB")`` as the reference does:
alpha is dropped, not composited. ``preprocess_batch`` is the JAX
package's batched device path: bicubic resize with antialias
(``jax.image.resize``, written out by ``ops.image.resize_bicubic``), center
crop, normalise — close to PIL's resampler, not bit-identical to it.
"""

from __future__ import annotations

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.ops.image import resize_bicubic

try:  # PIL is required for the host path only.
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_pil(img, size: int = 224) -> np.ndarray:
    """PIL path: [size, size, 3] float32, normalised. Parity with torch."""
    if img.mode != "RGB":
        img = img.convert("RGB")
    w, h = img.size
    # torchvision Resize(int): shorter side -> size, longer side truncated
    # (int(), not round() — matches torchvision and HF exactly), bicubic.
    if w < h:
        new_w, new_h = size, max(size, int(size * h / w))
    else:
        new_w, new_h = max(size, int(size * w / h)), size
    img = img.resize((new_w, new_h), Image.BICUBIC)
    # CenterCrop(size) — torchvision rounds the same way.
    left = int(round((new_w - size) / 2.0))
    top = int(round((new_h - size) / 2.0))
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def load_and_preprocess(path, size: int = 224) -> np.ndarray | None:
    """Open → RGB → preprocess; returns None on unreadable files (the
    reference logs and skips, 31_clip_embedding_and_save_vector.py:30-39)."""
    try:
        with Image.open(path) as img:
            return preprocess_pil(img, size)
    except Exception:
        return None


def preprocess_batch(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Device path: uint8/float [B, H, W, 3] (0..255) → normalised
    [B, size, size, 3] f32 on the images' device. Resizes the shorter side
    to ``size`` (bicubic, antialiased), then center-crops."""
    images = images.to(torch.float32) / 255.0
    B, H, W, C = images.shape
    if H < W:
        new_h, new_w = size, max(size, int(size * W / H))
    else:
        new_h, new_w = max(size, int(size * H / W)), size
    resized = resize_bicubic(images, new_h, new_w)
    top = int(round((new_h - size) / 2.0))
    left = int(round((new_w - size) / 2.0))
    crop = torch.clamp(resized[:, top: top + size, left: left + size], 0.0,
                       1.0)
    mean = torch.from_numpy(CLIP_MEAN).to(crop.device)
    std = torch.from_numpy(CLIP_STD).to(crop.device)
    return (crop - mean) / std


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
