"""Batched CLIP embedding + gallery upsert (the 31_* stage).

``make_encoder`` builds a CLIP tower on the device and returns a batch
encoder; ``embed_arrays`` embeds preprocessed arrays and upserts them with
the reference's payloads and MD5-of-path point IDs. The directory walker
(``embed_tree``) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.gallery.schema import Payload
from retrieval_based_object_detection_tpu_torch.gallery.store import Gallery
from retrieval_based_object_detection_tpu_torch.models.clip import (
    model as clip_model,
)
from retrieval_based_object_detection_tpu_torch.utils.ids import (
    point_id_from_path,
)


def make_encoder(
    params: dict[str, Any],
    config: clip_model.CLIPVisionConfig = clip_model.VIT_B_32,
    compute_dtype: str = "float32",
    device: str | torch.device = "cuda",
) -> Callable[[np.ndarray], np.ndarray]:
    """Batch encoder: [B, H, W, 3] float32 preprocessed images → [B, D]
    f32 numpy embeddings, computed on ``device`` in ``compute_dtype``
    ("float32" or "bfloat16"). ``params`` is a state dict or a
    JAX-layout numpy pytree."""
    dtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    tower = clip_model.build_tower(params, config, dtype=dtype, device=device)

    def encode(batch: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(batch, np.float32), device=tower.device)
        return clip_model.encode_image(tower, x).cpu().numpy()

    return encode


def embed_arrays(
    gallery: Gallery,
    encoder: Callable[[np.ndarray], np.ndarray],
    images: np.ndarray,  # [N, H, W, 3] already preprocessed
    paths: Sequence[str],
    class_names: Sequence[str],
    img_type: str = "original",
    is_segmented: bool = False,
    is_augmented: bool = False,
    batch_size: int = 64,
) -> int:
    """In-memory variant (no filesystem): embed + upsert preprocessed
    arrays in fixed-size (zero-padded) batches."""
    n = images.shape[0]
    for start in range(0, n, batch_size):
        chunk = images[start: start + batch_size]
        real = chunk.shape[0]
        if real < batch_size:
            padded = np.zeros((batch_size,) + chunk.shape[1:], chunk.dtype)
            padded[:real] = chunk
            chunk = padded
        vecs = encoder(chunk)[:real]
        sl = slice(start, start + real)
        gallery.upsert(
            [point_id_from_path(p) for p in paths[sl]],
            vecs.astype(np.float32),
            [
                Payload(
                    data_type=f"{img_type}_images",
                    is_cropped=True,
                    is_segmented=is_segmented,
                    is_augmented=is_augmented,
                    class_name=c,
                    img_path=str(p),
                )
                for p, c in zip(paths[sl], class_names[sl])
            ],
        )
    return n
