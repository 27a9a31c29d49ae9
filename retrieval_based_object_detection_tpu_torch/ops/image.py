"""Batched resampling on the device: crop + resize for detection → embed
serving, and the bicubic resize of the CLIP device preprocess.

``crop_resize_batch`` reproduces the JAX package's
``jax.image.scale_and_translate(method="bilinear", antialias=True)`` per
image, and ``resize_bicubic`` its ``jax.image.resize(method="bicubic",
antialias=True)``: one weight matrix per spatial axis (``jax.image``'s
``compute_weight_mat``: a triangle or Keys cubic kernel that widens by
1/scale when it downsamples, the weights of each output normalised to sum
to 1), applied as one einsum per axis. ``F.interpolate`` takes no
per-image translation and its cubic kernel and antialias differ, so it is
not used.
"""

from __future__ import annotations

import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel (a = -0.5) on x >= 0, as
    ``jax.image`` writes it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _weight_mat(input_size: int, output_size: int, inv_scale: torch.Tensor,
                translation: torch.Tensor, kernel=_triangle) -> torch.Tensor:
    """[B, input_size, output_size] antialiased ``kernel`` weights
    (``compute_weight_mat`` of jax.image) for per-image inverse scale and
    translation [B]. Each sample position is rounded to f32 once, as XLA's
    fused multiply-add rounds it."""
    dev = inv_scale.device
    inv_scale = inv_scale[:, None, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    centres = (torch.arange(output_size, dtype=torch.float32, device=dev)
               + 0.5)[None, None, :]
    inv64 = inv_scale.to(torch.float64)
    sample_f = (centres.to(torch.float64) * inv64
                - translation[:, None, None].to(torch.float64) * inv64
                - 0.5).to(torch.float32)
    x = torch.abs(sample_f - torch.arange(
        input_size, dtype=torch.float32, device=dev)[None, :, None]
    ) / kernel_scale
    weights = kernel(x)
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
    wy = _weight_mat(images.shape[1], out_size, 1.0 / scale_y,
                     -y1 * scale_y)
    wx = _weight_mat(images.shape[2], out_size, 1.0 / scale_x,
                     -x1 * scale_x)
    rows = torch.einsum("bhwc,bhy->bywc", images, wy)
    return torch.einsum("bywc,bwx->byxc", rows, wx)


def resize_bicubic(images: torch.Tensor, new_h: int, new_w: int
                   ) -> torch.Tensor:
    """[B, H, W, C] f32 → [B, new_h, new_w, C]: ``jax.image.resize(...,
    method="bicubic", antialias=True)``. An axis whose size does not
    change is left as it is, as jax.image leaves it. The inverse scale is
    taken in double and rounded to f32 once, as jax.image takes it from
    its Python float scale."""
    B, H, W, C = images.shape
    dev = images.device

    def weights(n_in: int, n_out: int) -> torch.Tensor:
        inv = torch.tensor([1.0 / (n_out / n_in)], device=dev)
        return _weight_mat(n_in, n_out, inv, torch.zeros(1, device=dev),
                           _keys_cubic)[0]

    if new_h != H:
        images = torch.einsum("bhwc,hy->bywc", images, weights(H, new_h))
    if new_w != W:
        images = torch.einsum("bywc,wx->byxc", images, weights(W, new_w))
    return images
