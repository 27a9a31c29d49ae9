"""Offline ingest of one crop file, in plain NumPy and PIL: the
preprocessing of OpenAI CLIP's ``clip.load`` transform (torchvision's
Resize(224, bicubic) of the shorter side, with the longer side
truncated, CenterCrop(224), ToTensor, Normalize), one image at a time.
The tower is ``reference.clip``."""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess(path: str, size: int = 224) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        w, h = img.size
        if w < h:
            nw, nh = size, max(size, int(size * h / w))
        else:
            nw, nh = max(size, int(size * w / h)), size
        img = img.resize((nw, nh), Image.BICUBIC)
        left = int(round((nw - size) / 2.0))
        top = int(round((nh - size) / 2.0))
        img = img.crop((left, top, left + size, top + size))
        arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD
