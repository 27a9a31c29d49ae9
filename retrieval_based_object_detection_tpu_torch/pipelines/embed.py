"""Batched CLIP embedding + gallery upsert (the 31_* stage).

``make_encoder`` builds a CLIP tower on the device and returns a batch
encoder. ``embed_tree`` walks a stage root's directory contract, decodes
and preprocesses the next batch on host threads while the device encodes
the current one, and upserts the vectors with the reference's payloads and
MD5-of-path point IDs; ``embed_arrays`` does the same for arrays already in
memory.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.gallery.schema import Payload
from retrieval_based_object_detection_tpu_torch.gallery.store import Gallery
from retrieval_based_object_detection_tpu_torch.models.clip import (
    model as clip_model,
)
from retrieval_based_object_detection_tpu_torch.models.clip import (
    preprocess as pp,
)
from retrieval_based_object_detection_tpu_torch.utils import tree
from retrieval_based_object_detection_tpu_torch.utils.ids import (
    point_id_from_path,
)
from retrieval_based_object_detection_tpu_torch.utils.loader import (
    PrefetchIterator,
    batched,
    parallel_map,
)


@dataclasses.dataclass
class EmbedConfig:
    root_dir: str  # dataset_cropped | dataset_segmented | dataset_augmented
    img_type: str = "original"  # original | natural
    classes: list[str] | None = None  # None = all
    batch_size: int = 64
    image_size: int = 224  # must match the encoder's config.image_size
    # NB: numeric precision is the ENCODER's property — set it where the
    # encoder is built (make_encoder(compute_dtype=...)).


@dataclasses.dataclass
class EmbedResult:
    per_class_counts: dict[str, int]
    n_failed: int

    @property
    def total(self) -> int:
        return sum(self.per_class_counts.values())


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


def embed_tree(
    gallery: Gallery,
    encoder: Callable[[np.ndarray], np.ndarray],
    cfg: EmbedConfig,
    logger=None,
) -> EmbedResult:
    """Embed every image under the stage root and upsert into the gallery.

    Payload derivation matches 31_clip_embedding_and_save_vector.py:154-175:
    data_type from the img_type, is_segmented/is_augmented from the root
    basename, class from the directory name, MD5-of-path point IDs.

    A worker thread decodes and preprocesses the NEXT batch (per-image
    work fanned out over ``parallel_map``) while the device encodes the
    current one.
    """
    flags = tree.stage_flags(cfg.root_dir)
    entries = tree.walk(cfg.root_dir, cfg.img_type, cfg.classes)
    counts: dict[str, int] = {}
    n_failed = 0
    n_done = 0
    B = cfg.batch_size

    def prepare(chunk: list[tree.ImageEntry]):
        arrs = parallel_map(
            lambda e: pp.load_and_preprocess(e.path, size=cfg.image_size),
            chunk)
        imgs, paths, classes, failed = [], [], [], 0
        for e, arr in zip(chunk, arrs):
            if arr is None:
                failed += 1
                continue
            imgs.append(arr)
            paths.append(e.path)
            classes.append(e.class_name)
        return imgs, paths, classes, failed

    t0 = time.perf_counter()
    loader = PrefetchIterator(batched(entries, B), prepare, depth=2)
    try:
        for imgs, paths, classes, failed in loader:
            n_failed += failed
            if not imgs:
                continue
            padded, _ = pp.pad_batch(imgs, B)
            vecs = encoder(padded)[: len(imgs)]
            ids = [point_id_from_path(p) for p in paths]
            payloads = [
                Payload(
                    data_type=f"{cfg.img_type}_images",
                    is_cropped=True,
                    is_segmented=flags["is_segmented"],
                    is_augmented=flags["is_augmented"],
                    class_name=c,
                    is_delegate=False,
                    delegate_type=None,
                    img_path=str(p),
                )
                for p, c in zip(paths, classes)
            ]
            gallery.upsert(ids, vecs.astype(np.float32), payloads)
            n_done += len(imgs)
            for c in classes:
                counts[c] = counts.get(c, 0) + 1
    finally:
        loader.close()
    if logger is not None:
        per_sec = n_done / max(time.perf_counter() - t0, 1e-9)
        logger.summary(total=n_done, failed=n_failed,
                       crops_per_sec=round(per_sec, 1))
    return EmbedResult(per_class_counts=counts, n_failed=n_failed)


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
