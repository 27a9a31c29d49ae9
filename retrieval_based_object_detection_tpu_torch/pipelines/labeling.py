"""Letterboxing for the serving endpoint (the rest of the JAX package's
labeling stage is not ported yet)."""

from __future__ import annotations

import numpy as np


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
