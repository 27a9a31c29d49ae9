"""Image ops on the device: the augmentation grid of the augment stage,
crop + resize for detection → embed serving, and the bicubic resize of
the CLIP device preprocess.

The augment ops follow the JAX package's ``ops/image.py``: images are
float32 ``[*, H, W, C]`` tensors in 0..255 (alpha included), angles are
degrees counter-clockwise like PIL, and every op returns a tensor on the
device its input came on. ``brightness``, ``rotate_expand`` and
``gaussian_blur`` equal the JAX package's output bit for bit; the noise
ops draw from a ``torch.Generator`` (threefry's bits cannot be
reproduced), so they agree with JAX in distribution and equal it when
both are fed the same draws.

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

import math

import numpy as np
import torch

BRIGHTNESS_RATES = (1.2, 1.1, 1.05, 0.95, 0.9, 0.8)
ROTATION_ANGLES = (30, 60, 90, 120, 150, 180, 210, 240, 270, 300, 330)
NOISE_TYPES = ("gaussian", "blur", "snp")
NOISE_LEVELS = (0.01, 0.02, 0.03)

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


# ------------------------------------------------------------ brightness
def brightness(images: torch.Tensor, rate: float) -> torch.Tensor:
    """PIL ImageEnhance.Brightness semantics: colour bands scale by
    ``rate`` with truncation; the alpha band (4-channel input) is
    preserved — PIL blends with a black image that keeps the alpha."""
    scaled = torch.clamp(torch.floor(images * rate), 0.0, 255.0)
    if images.shape[-1] == 4:
        scaled[..., 3] = images[..., 3]
    return scaled


# ------------------------------------------------------------ rotation
def _pil_rotation_matrix(w: int, h: int, angle_deg: float) -> list[float]:
    """PIL's destination→source affine matrix for rotate() about the image
    center: trig rounded to 15 decimals, offsets via center transform."""
    a_rad = -math.radians(angle_deg % 360.0)
    m = [round(math.cos(a_rad), 15), round(math.sin(a_rad), 15), 0.0,
         round(-math.sin(a_rad), 15), round(math.cos(a_rad), 15), 0.0]
    cx, cy = w / 2.0, h / 2.0
    m[2] = m[0] * (-cx) + m[1] * (-cy) + cx
    m[5] = m[3] * (-cx) + m[4] * (-cy) + cy
    return m


def rotate_expand_size(w: int, h: int, angle_deg: float) -> tuple[int, int]:
    """Output (w, h) of PIL rotate(expand=True) — PIL's corner transform
    and ceil/floor, including the 90/180/270 transpose fast paths."""
    angle = angle_deg % 360.0
    if angle == 0 or angle == 180:
        return w, h
    if angle in (90, 270):
        return h, w
    m = _pil_rotation_matrix(w, h, angle_deg)
    xx, yy = [], []
    for x, y in ((0, 0), (w, 0), (w, h), (0, h)):
        xx.append(m[0] * x + m[1] * y + m[2])
        yy.append(m[3] * x + m[4] * y + m[5])
    return (
        int(math.ceil(max(xx)) - math.floor(min(xx))),
        int(math.ceil(max(yy)) - math.floor(min(yy))),
    )


def _fma_f32(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a·x + y`` rounded once to f32, with ``a`` rounded to f32 first."""
    a32 = float(np.float32(a))
    return (x.to(torch.float64) * a32 + y.to(torch.float64)).to(torch.float32)


def rotate_expand(image: torch.Tensor, angle_deg: float) -> torch.Tensor:
    """Rotate one [H, W, C] image CCW onto an expanded transparent canvas,
    nearest-neighbour sampling — PIL rotate(expand=True) semantics,
    including the exact transpose fast paths at 90/180/270.

    The source coordinates are formed as XLA forms them on the CPU: the
    first product fused into the sum with the rounded second
    (``fma(m0, x, m1·y) + t`` in f32). The fused step runs in float64,
    where the product of two f32 values is exact, so the card and the
    CPU truncate the same values as the JAX package."""
    h, w = image.shape[0], image.shape[1]
    angle = angle_deg % 360.0
    if angle == 0:
        return image
    if angle in (90, 180, 270):
        return torch.rot90(image, k=int(angle) // 90, dims=(0, 1))
    ow, oh = rotate_expand_size(w, h, angle_deg)
    m = _pil_rotation_matrix(w, h, angle_deg)
    # Expand adjustment: shift so the rotated bbox starts at the origin.
    tx = m[0] * (-(ow - w) / 2.0) + m[1] * (-(oh - h) / 2.0) + m[2]
    ty = m[3] * (-(ow - w) / 2.0) + m[4] * (-(oh - h) / 2.0) + m[5]
    dev = image.device
    # PIL nearest: src = trunc(m @ (x+0.5, y+0.5)), negatives fall outside.
    oy = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5
          )[:, None].expand(oh, ow)
    ox = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5
          )[None, :].expand(oh, ow)
    sx = _fma_f32(m[0], ox, m[1] * oy) + tx
    sy = _fma_f32(m[3], ox, m[4] * oy) + ty
    ix = sx.to(torch.int32)  # trunc toward zero like PIL's COORD macro
    iy = sy.to(torch.int32)
    inside = (sx >= 0) & (ix < w) & (sy >= 0) & (iy < h)
    ix = torch.clamp(ix, 0, w - 1).long()
    iy = torch.clamp(iy, 0, h - 1).long()
    out = image[iy, ix]
    return torch.where(inside[..., None], out, 0.0)


# ------------------------------------------------------------ noise
def _draw(shape, generator: torch.Generator, uniform: bool) -> torch.Tensor:
    fn = torch.rand if uniform else torch.randn
    return fn(tuple(shape), generator=generator, dtype=torch.float32,
              device=generator.device)


def gaussian_noise(images: torch.Tensor, amount: float,
                   generator: torch.Generator) -> torch.Tensor:
    """img + N(0, 25)·amount, clipped (23_augmentation.py:43-47). The
    draws come from ``generator`` on its own device and are moved to the
    images' device, so a CPU generator gives the same noise to a run on
    the card as to one on the CPU."""
    normal = _draw(images.shape, generator, uniform=False)
    return _add_gaussian(images, amount, normal.to(images.device))


def _add_gaussian(images: torch.Tensor, amount: float,
                  normal: torch.Tensor) -> torch.Tensor:
    noise = 25.0 * normal
    return torch.clamp(images + noise * amount, 0.0, 255.0)


def _gaussian_kernel(radius: int) -> torch.Tensor:
    """PIL semantics: GaussianBlur(radius) treats radius as the Gaussian
    STANDARD DEVIATION; support extends to ~3 sigma. f32 on the CPU."""
    sigma = max(float(radius), 1e-6)
    support = max(1, int(3 * radius))
    x = torch.arange(-support, support + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _blur_axis(x: torch.Tensor, taps: list[float], axis: int) -> torch.Tensor:
    """Edge-padded 'valid' correlation of ``x`` with ``taps`` along
    ``axis``: each tap's product and each running sum one f32 op, taps in
    order, so every device rounds alike (no TF32, no fused multiply-add)."""
    pad = (len(taps) - 1) // 2
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(-pad, n + pad, device=x.device), 0, n - 1)
    xp = x.index_select(axis, idx)
    acc = None
    for i, t in enumerate(taps):
        term = t * xp.narrow(axis, i, n)
        acc = term if acc is None else acc + term
    return acc


def gaussian_blur(images: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable gaussian blur over H and W of [B, H, W, C] (or [H, W, C]),
    edge padding, rounded half to even and clipped."""
    if radius <= 0:
        return images
    squeeze = images.ndim == 3
    x = images[None] if squeeze else images
    taps = [float(t) for t in _gaussian_kernel(radius)]
    x = _blur_axis(x.to(torch.float32), taps, 1)
    x = _blur_axis(x, taps, 2)
    x = torch.clamp(torch.round(x), 0.0, 255.0)
    return x[0] if squeeze else x


def salt_pepper(images: torch.Tensor, amount: float,
                generator: torch.Generator) -> torch.Tensor:
    """Set ~amount·(H·W) random pixels (all channels) to 0 or 255
    (23_augmentation.py:53-64 semantics, vectorised). Draws as
    ``gaussian_noise`` does."""
    spatial = images.shape[:-1]
    hit = _draw(spatial, generator, uniform=True)
    salt = _draw(spatial, generator, uniform=True)
    return _apply_salt_pepper(images, amount, hit.to(images.device),
                              salt.to(images.device))


def _apply_salt_pepper(images: torch.Tensor, amount: float,
                       u_hit: torch.Tensor, u_salt: torch.Tensor
                       ) -> torch.Tensor:
    hit = u_hit < amount
    val = torch.where(u_salt < 0.5, 255.0, 0.0)[..., None]
    return torch.where(hit[..., None], val, images)


def expand_box_with_margin(
    box_xyxy, img_w: int, img_h: int, margin_ratio: float = 0.2
):
    """Grow each side by margin_ratio × box size, clamped to image
    bounds (the 21_crop_image.py:89-95 rule SHAPE). Works on [..., 4].
    For float detector boxes this is exact; for YOLO labels the
    byte-parity path is pipelines.crop.yolo_crop_bounds, whose margins
    come from the float pixel dims rather than this function's corner
    differences (one-pixel divergence when the corners are
    pre-truncated ints). Host numpy."""
    box = np.asarray(box_xyxy, np.float32)
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    mx = (w * margin_ratio).astype(np.int32)
    my = (h * margin_ratio).astype(np.int32)
    out = np.stack([
        np.maximum(box[..., 0].astype(np.int32) - mx, 0),
        np.maximum(box[..., 1].astype(np.int32) - my, 0),
        np.minimum(box[..., 2].astype(np.int32) + mx, img_w),
        np.minimum(box[..., 3].astype(np.int32) + my, img_h),
    ], axis=-1)
    return out
