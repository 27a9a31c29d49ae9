"""TinyDet training loop: fit the detector on a labeled JPEG tree.

Consumes exactly what the labeling + review stages produce (YOLO labels
next to images), letterboxes to the detector's square input, and runs the
focal/IoU train step on ``device`` — so a deployment can bootstrap its
own detector from saliency-proposed + human-reviewed labels and swap it
into ``run_labeling(detector=...)`` or serve it behind
``RetrievalDetector(detector=...)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.models.detector import tinydet
from retrieval_based_object_detection_tpu_torch.pipelines.crop import (
    parse_yolo_label,
    yolo_to_xyxy,
)
from retrieval_based_object_detection_tpu_torch.pipelines.labeling import (
    letterbox,
)
from retrieval_based_object_detection_tpu_torch.utils import tree
from retrieval_based_object_detection_tpu_torch.utils.loader import (
    PrefetchIterator,
    batched,
)
from retrieval_based_object_detection_tpu_torch.utils.logging import (
    StageLogger,
)
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


@dataclasses.dataclass
class DetFitConfig:
    root_dir: str = "dataset_jpeg"
    img_type: str = "original"
    epochs: int = 10
    batch_size: int = 8
    learning_rate: float = 1e-3
    max_boxes: int = 8
    seed: int = 0


def fit_detector(
    config: tinydet.TinyDetConfig,
    cfg: DetFitConfig,
    params=None,
    device: str | torch.device = "cuda",
):
    """→ (params, last_metrics). Images lacking labels are skipped.
    ``params`` (a port tree or the JAX package's) starts the fit; None
    draws ``init_params(config, cfg.seed)``. The returned tree lives on
    ``device``."""
    dev = resolve_device(device)
    entries = [e for e in tree.walk(cfg.root_dir, cfg.img_type)
               if e.path.with_suffix(".txt").exists()]
    if not entries:
        raise ValueError(f"no labeled images under {cfg.root_dir}")
    if len(entries) < cfg.batch_size:
        raise ValueError(
            f"batch_size {cfg.batch_size} exceeds labeled set "
            f"{len(entries)}")

    params = tinydet.params_from_jax(
        params if params is not None
        else tinydet.init_params(config, seed=cfg.seed), device=dev)
    step, opt_init = tinydet.make_train_step(config, cfg.learning_rate)
    opt_state = opt_init(params)
    log = StageLogger("train-detector")
    rng = np.random.default_rng(cfg.seed)
    S = config.image_size

    def prepare(chunk):
        from PIL import Image

        imgs, boxes, valid = [], [], []
        for e in chunk:
            try:
                with Image.open(e.path) as im:
                    arr = np.asarray(im.convert("RGB"))
            except Exception:
                continue
            canvas, scale = letterbox(arr, S)
            gt = np.zeros((cfg.max_boxes, 4), np.float32)
            gv = np.zeros(cfg.max_boxes, bool)
            labels = parse_yolo_label(e.path.with_suffix(".txt"))
            for j, lab in enumerate(labels[: cfg.max_boxes]):
                x1, y1, x2, y2 = yolo_to_xyxy(lab, arr.shape[1],
                                              arr.shape[0])
                gt[j] = np.clip(np.asarray(
                    [x1, y1, x2, y2], np.float32) * scale, 0, S)
                gv[j] = True
            imgs.append(canvas.astype(np.float32))
            boxes.append(gt)
            valid.append(gv)
        return imgs, boxes, valid

    metrics = {}
    for epoch in range(cfg.epochs):
        order = rng.permutation(len(entries))
        shuffled = [entries[i] for i in order]
        full = shuffled[: len(shuffled) - len(shuffled) % cfg.batch_size]
        loader = PrefetchIterator(batched(full, cfg.batch_size), prepare)
        n_fill = 0
        try:
            for imgs, boxes, valid in loader:
                if not imgs:
                    continue
                # Decode failures shrink the batch; refill by cycling the
                # good samples so every step sees a full batch (counted +
                # logged, not silent).
                orig_n = len(imgs)
                while len(imgs) < cfg.batch_size:
                    j = (len(imgs) - orig_n) % orig_n
                    imgs.append(imgs[j])
                    boxes.append(boxes[j])
                    valid.append(valid[j])
                    n_fill += 1
                params, opt_state, metrics = step(
                    params, opt_state, np.stack(imgs), np.stack(boxes),
                    np.stack(valid))
        finally:
            loader.close()
        if n_fill:
            log.event("refill", repeated_samples=n_fill)
        if not metrics:
            # Same guard as train/loop.py: every image failing to decode
            # must be a clear error, not a KeyError below.
            raise ValueError(
                "no trainable batches survived decoding — every labeled "
                "image in the tree failed to load")
        log.event("epoch", epoch=epoch,
                  loss=round(float(metrics["loss"]), 4),
                  n_pos=int(metrics["n_pos"]))
    log.summary(epochs=cfg.epochs)
    for p in tinydet.leaves(params):
        p.requires_grad_(False)
    return params, {k: float(v) for k, v in metrics.items()}


class TinyDetDetector:
    """Detector-callable over trained TinyDet params (the drop-in for
    ``run_labeling(detector=...)`` and ``RetrievalDetector``): numpy
    canvases in, numpy (boxes [B, K, 4], scores [B, K]) out, the decode
    on ``device``."""

    def __init__(self, params, config: tinydet.TinyDetConfig,
                 conf_threshold: float = 0.25,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.params = tinydet.params_from_jax(params, device=self.device)
        self.config = config
        self.conf_threshold = conf_threshold

    def __call__(self, images: np.ndarray):
        boxes, scores = tinydet.decode(
            self.params,
            torch.as_tensor(np.asarray(images, np.float32),
                            device=self.device),
            self.config, conf_threshold=self.conf_threshold)
        return boxes.cpu().numpy(), scores.cpu().numpy()
