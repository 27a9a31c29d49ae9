"""YOLOv8 as the labeling-slot detector callable.

Drop-in for ``pipelines/labeling.py``'s pluggable detector interface
(images [B, H, W, 3] → (boxes [B, K, 4] xyxy px, scores [B, K]), numpy in
and out) with the reference's semantics: conf-0.25 gate, top-K by
confidence (11_dataset_labeling.py:159, 178-180). The forward and the DFL
decode run as one batch on the device; NMS and the top-K cut are
host-side NumPy.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.models.yolo import model as Y
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class _DetConfig:
    image_size: int  # labeling letterboxes to this square (÷32)


class YoloDetector:
    """Detector-callable around a YOLOv8 model: a ``YoloV8`` module, a
    ``YoloV8`` state dict, or the JAX package's param list."""

    def __init__(self, params_or_module, config: Y.YoloConfig,
                 image_size: int = 640, conf_threshold: float = 0.25,
                 iou_threshold: float = 0.45, max_det: int = 16,
                 device: str | torch.device = "cuda"):
        if image_size % 32:
            raise ValueError(
                f"image_size must be divisible by 32 (stride-32 head); "
                f"got {image_size}")
        if isinstance(params_or_module, Y.YoloV8):
            model = params_or_module.to(resolve_device(device)).eval()
        else:
            state = (params_or_module if isinstance(params_or_module, dict)
                     else Y.params_from_jax(params_or_module))
            model = Y.build_model(state, config, device=device)
        self.model = model
        self.yolo_config = config
        self.config = _DetConfig(image_size=image_size)
        self.conf_threshold = conf_threshold
        self.iou_threshold = iou_threshold
        self.max_det = max_det

    @classmethod
    def from_checkpoint(cls, path: str | Path,
                        device: str | torch.device = "cuda",
                        **kw) -> "YoloDetector":
        from retrieval_based_object_detection_tpu_torch.models.yolo.convert import (  # noqa: E501
            load_torch_checkpoint,
        )

        model, config = load_torch_checkpoint(path, device=device)
        return cls(model, config, device=device, **kw)

    @classmethod
    def from_variant(cls, variant: str = "yolov8s",
                     cache_dir: str | Path = "model",
                     **kw) -> "YoloDetector":
        """Official weights by name — downloads into ``model/`` exactly
        once (the reference's own asset location, 11:10)."""
        from retrieval_based_object_detection_tpu_torch.models.yolo.download import (  # noqa: E501
            ensure_checkpoint,
        )

        return cls.from_checkpoint(
            ensure_checkpoint(variant, cache_dir=cache_dir), **kw)

    def __call__(self, images: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
        imgs = np.asarray(images, np.float32)
        if imgs.max() > 1.5:  # uint8-range canvases from the letterbox
            imgs = imgs / 255.0
        if imgs.shape[1] % 32 or imgs.shape[2] % 32:
            raise ValueError(
                f"input {imgs.shape[1]}x{imgs.shape[2]} not divisible by "
                f"32 — letterbox to a stride-32 size (e.g. "
                f"{self.config.image_size})")
        boxes, cls_probs = Y.predict(
            self.model, torch.as_tensor(imgs, device=self.model.device))
        dets = Y.postprocess(boxes.cpu().numpy(), cls_probs.cpu().numpy(),
                             conf_threshold=self.conf_threshold,
                             iou_threshold=self.iou_threshold,
                             max_det=self.max_det)
        B, K = imgs.shape[0], self.max_det
        out_b = np.zeros((B, K, 4), np.float32)
        out_s = np.zeros((B, K), np.float32)
        for i, d in enumerate(dets):
            n = min(K, d["boxes"].shape[0])
            out_b[i, :n] = d["boxes"][:n]
            out_s[i, :n] = d["scores"][:n]
        return out_b, out_s
