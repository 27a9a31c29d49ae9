"""Seeded synthetic images (after ``chip_smoke.py``'s ``synthetic_crop``
and ``product_photo``) and their JPEG bytes.

Every image is drawn from ``numpy.random.default_rng([seed, tag, index])``
so that it does not depend on which other images were made.
"""

from __future__ import annotations

import colorsys
import io

import numpy as np

SEED_MASK = (1 << 63) - 1


def rng_for(seed: int, tag: int, index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & SEED_MASK, tag, index])


def class_color(c: int) -> tuple[int, int, int]:
    """A distinct saturated colour for class ``c`` (golden-ratio hues,
    three value levels)."""
    h = (c * 0.618033988749895) % 1.0
    v = (0.55, 0.75, 0.95)[c % 3]
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, v)
    return int(r * 255), int(g * 255), int(b * 255)


def synthetic_crop(rng, color, h: int, w: int) -> np.ndarray:
    """A product-like crop: a coloured rectangle on a light background
    with mild noise, uint8 [h, w, 3]."""
    img = np.full((h, w, 3), 225, np.int16)
    y0 = int(rng.integers(h // 12, h // 5))
    x0 = int(rng.integers(w // 12, w // 5))
    y1 = h - int(rng.integers(h // 12, h // 5))
    x1 = w - int(rng.integers(w // 12, w // 5))
    img[y0:y1, x0:x1] = color
    img += rng.integers(0, 12, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def product_photo(rng, color, h: int, w: int) -> np.ndarray:
    """A studio shot: a light, slightly graded background with one
    coloured product and its shadow at a random box, uint8 [h, w, 3]."""
    bh = int(rng.integers(h // 4, h // 2))
    bw = int(rng.integers(w // 5, w // 2))
    y = int(rng.integers(h // 12, h - bh - h // 12))
    x = int(rng.integers(w // 12, w - bw - w // 12))
    ramp = np.linspace(-8, 8, w, dtype=np.float32)[None, :, None]
    img = np.full((h, w, 3), 228.0, np.float32) + ramp
    img[y + 6:y + bh + 6, x + 6:x + bw + 6] *= 0.8   # shadow
    img[y:y + bh, x:x + bw] = color
    img += rng.integers(0, 10, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg(img: np.ndarray, quality: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()
