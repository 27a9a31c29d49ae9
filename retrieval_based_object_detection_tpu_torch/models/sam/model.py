"""SAM model wrapper: preprocessing + encode-once/predict-many interface.

Mirrors the SamPredictor usage pattern the reference drives
(22_segment_image_auto.py:139-152): ``set_image`` runs the ViT encoder
once (the expensive part, with kernel B6 in every attention layer on the
card), then each ``predict`` call decodes point prompts into 3 candidate
masks + IoU scores — the split that matters for the manual click UI
(22m). ``segment_batch`` encodes a batch of images in one call for the
auto-segment stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.models.sam import decoder as D
from retrieval_based_object_detection_tpu_torch.models.sam import encoder as E
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)

# SAM pixel normalisation (ImageNet stats on 0..255 scale).
SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclasses.dataclass(frozen=True)
class SamConfig:
    encoder: E.EncoderConfig = E.EncoderConfig()
    decoder: D.DecoderConfig = D.DecoderConfig()

    @property
    def img_size(self) -> int:
        return self.encoder.img_size


SAM_VIT_B = SamConfig()
# Small config for CPU tests: 128px input, 2 layers, tiny dims.
SAM_TINY = SamConfig(
    encoder=E.EncoderConfig(img_size=128, patch_size=16, embed_dim=64,
                            depth=2, heads=2, out_chans=32, window_size=4,
                            global_attn_indexes=(1,)),
    decoder=D.DecoderConfig(embed_dim=32, depth=2, heads=2, mlp_dim=64,
                            iou_head_hidden=32),
)


def init_params(config: SamConfig = SAM_TINY, seed: int = 0) -> dict:
    """The JAX package's init as a numpy pytree; ``params_from_jax`` turns
    it (or any JAX SAM pytree) into tensors."""
    return {
        "encoder": E.init_params(config.encoder, seed),
        "decoder": D.init_params(config.decoder, seed + 1),
    }


def params_from_jax(tree: Any, device: str | torch.device = "cpu") -> Any:
    """A JAX SAM pytree (numpy or JAX arrays; dense weights ``x @ w``,
    conv kernels HWIO) → the same nesting of f32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def preprocess_image(img: np.ndarray, img_size: int
                     ) -> tuple[np.ndarray, tuple[int, int]]:
    """Resize longest side to img_size, normalise, zero-pad to square.
    Returns (padded [S, S, 3] float32, (new_h, new_w))."""
    from PIL import Image

    h, w = img.shape[:2]
    scale = img_size / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    resized = np.asarray(
        Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.float32)
    resized = (resized - SAM_MEAN) / SAM_STD
    out = np.zeros((img_size, img_size, 3), np.float32)
    out[:nh, :nw] = resized
    return out, (nh, nw)


class SamPredictor:
    """set_image → predict(point) interface over the functional model."""

    def __init__(self, params, config: SamConfig = SAM_TINY,
                 compute_dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.params = params_from_jax(params, self.device)
        self.config = config
        self.compute_dtype = compute_dtype
        self._embedding: torch.Tensor | None = None
        self._orig_hw: tuple[int, int] | None = None
        self._resized_hw: tuple[int, int] | None = None

    @torch.inference_mode()
    def _encode(self, padded: np.ndarray) -> torch.Tensor:
        return E.forward(self.params["encoder"],
                         torch.from_numpy(padded).to(self.device),
                         self.config.encoder, self.compute_dtype)

    @torch.inference_mode()
    def _decode(self, embedding: torch.Tensor, pts: np.ndarray,
                labels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        masks, iou = D.decode_masks(
            self.params["decoder"], embedding,
            torch.as_tensor(pts, dtype=torch.float32, device=self.device),
            torch.as_tensor(np.asarray(labels), device=self.device),
            self.config.decoder)
        return masks.cpu().numpy(), iou.cpu().numpy()

    def set_image(self, img: np.ndarray) -> None:
        """Run the image encoder once for this image ([H, W, 3] uint8)."""
        padded, resized_hw = preprocess_image(img, self.config.img_size)
        self._embedding = self._encode(padded[None])
        self._orig_hw = img.shape[:2]
        self._resized_hw = resized_hw

    def predict(
        self,
        point_coords: np.ndarray,  # [P, 2] pixel (x, y) in ORIGINAL image
        point_labels: np.ndarray,  # [P] 1=fg, 0=bg
        multimask_output: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """→ (masks [M, H, W] bool in original resolution, scores [M])."""
        if self._embedding is None:
            raise RuntimeError("call set_image first")
        oh, ow = self._orig_hw
        nh, nw = self._resized_hw
        S = self.config.img_size
        # Map original pixels → padded-square normalised coords; +0.5
        # pixel-centre shift as segment-anything's prompt encoder.
        pts = np.asarray(point_coords, np.float32)
        pts = np.stack([(pts[:, 0] * (nw / ow) + 0.5) / S,
                        (pts[:, 1] * (nh / oh) + 0.5) / S], axis=1)
        masks, iou = self._decode(self._embedding, pts[None],
                                  np.asarray(point_labels)[None])
        masks, iou = masks[0], iou[0]  # [tokens, 4g, 4g]
        if multimask_output:
            masks, iou = masks[1:], iou[1:]  # tokens 1..3 (multimask)
        else:
            masks, iou = masks[:1], iou[:1]
        return (_masks_to_original(masks, (nh, nw), (oh, ow), S), iou)

    def segment_batch(
        self,
        images: list[np.ndarray],   # [H_i, W_i, 3] uint8, any sizes
        point_coords: list[np.ndarray] | None = None,  # per-image [P, 2]
        point_labels: list[np.ndarray] | None = None,  # per-image [P]
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Batched encode→decode for throughput jobs (the auto-segment
        stage): one encoder call for the whole batch. Defaults to the
        reference's center-point prompt (22a:141-143); multi-point prompts
        must share one P across the batch, with ``point_labels`` 1=fg/0=bg
        per point like ``predict``. Returns per-image (3 candidate masks at
        original resolution, scores)."""
        S = self.config.img_size
        P = (len(np.asarray(point_coords[0]))
             if point_coords is not None else 1)
        padded, hw = [], []
        pts = np.zeros((len(images), P, 2), np.float32)
        labels = np.ones((len(images), P), np.float32)
        for i, img in enumerate(images):
            p, (nh, nw) = preprocess_image(img, S)
            padded.append(p)
            hw.append(((nh, nw), img.shape[:2]))
            oh, ow = img.shape[:2]
            raw = (np.asarray(point_coords[i], np.float32)
                   if point_coords is not None
                   else np.array([[ow / 2, oh / 2]], np.float32))
            if raw.shape != (P, 2):
                raise ValueError(
                    f"image {i}: expected {P} prompt points, got "
                    f"{raw.shape} (batched prompts share one P)")
            pts[i, :, 0] = (raw[:, 0] * (nw / ow) + 0.5) / S
            pts[i, :, 1] = (raw[:, 1] * (nh / oh) + 0.5) / S
            if point_labels is not None:
                labels[i] = np.asarray(point_labels[i], np.float32)
        emb = self._encode(np.stack(padded))
        masks, iou = self._decode(emb, pts, labels)
        masks, iou = masks[:, 1:], iou[:, 1:]  # multimask tokens 1..3
        return [
            (_masks_to_original(masks[i], *hw[i], S), iou[i])
            for i in range(len(images))
        ]


def _masks_to_original(mask_logits: np.ndarray, resized_hw, orig_hw,
                       img_size: int) -> np.ndarray:
    """[M, 4g, 4g] logits → [M, H, W] bool: upsample to the padded
    square, crop the content area, resize to original, threshold at 0."""
    from PIL import Image

    nh, nw = resized_hw
    oh, ow = orig_hw
    out = []
    for m in mask_logits:
        big = np.asarray(Image.fromarray(m.astype(np.float32)).resize(
            (img_size, img_size), Image.BILINEAR))
        crop = big[: int(nh), : int(nw)]
        full = np.asarray(Image.fromarray(crop).resize(
            (ow, oh), Image.BILINEAR))
        out.append(full > 0.0)
    return np.stack(out)
