"""Batched crop + resize for detection → embed serving.

``crop_resize_batch`` reproduces the JAX package's
``jax.image.scale_and_translate(method="bilinear", antialias=True)`` per
image: one weight matrix per spatial axis (a triangle kernel that widens
by 1/scale when it downsamples), applied as two einsums.
``F.interpolate`` takes no per-image translation and filters differently,
so it is not used.
"""

from __future__ import annotations

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


def _weight_mat(input_size: int, output_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """[B, input_size, output_size] antialiased triangle-kernel weights
    (``compute_weight_mat`` of jax.image) for per-image scale and
    translation [B]."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(output_size, dtype=torch.float32, device=dev)
                 + 0.5)[None, None, :] * inv_scale
                - translation[:, None, None] * inv_scale - 0.5)
    x = torch.abs(sample_f - torch.arange(
        input_size, dtype=torch.float32, device=dev)[None, :, None]
    ) / kernel_scale
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, 1.0), 0.0)
    # Zero the weights of samples entirely outside the input range.
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside, weights, 0.0)


def crop_resize_batch(
    images: torch.Tensor,  # [B, H, W, C] float32 0..255
    boxes: torch.Tensor,   # [B, 4] pixel xyxy (already margin-expanded)
    out_size: int = 224,
) -> torch.Tensor:
    """Each image's box resampled to [out_size, out_size] (bilinear,
    antialiased) → [B, out_size, out_size, C] f32."""
    images = images.to(torch.float32)
    boxes = boxes.to(torch.float32)
    x1, y1, x2, y2 = boxes.unbind(dim=1)
    scale_y = out_size / torch.clamp(y2 - y1, min=1.0)
    scale_x = out_size / torch.clamp(x2 - x1, min=1.0)
    wy = _weight_mat(images.shape[1], out_size, scale_y, -y1 * scale_y)
    wx = _weight_mat(images.shape[2], out_size, scale_x, -x1 * scale_x)
    rows = torch.einsum("bhwc,bhy->bywc", images, wy)
    return torch.einsum("bywc,bwx->byxc", rows, wx)
