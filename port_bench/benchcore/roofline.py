"""Peaks of one NVIDIA H100 SXM and the operations and bytes of the work
the metrics divide by.

Peaks are NVIDIA's data sheet's dense rates at the full 700 W limit: 989
TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s
of HBM. ``F32_3XTF32`` is not a published number: it is derived, three
TF32 products (495 TFLOP/s) for one f32-accurate product, and is the rate
of the port's f32 tensor-core kernels (B1 f32 computes so).

A bound is the least time the card could take: the larger of bytes over
bandwidth and operations over the peak. Bytes count each input read once
and each output written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {
    "bfloat16": 989e12,
    "int8": 1979e12,
    "float32": 67e12,
}
F32_3XTF32 = 495e12 / 3
ITEMSIZE = {"bfloat16": 2, "float32": 4, "int8": 1}


def bound_s(n_bytes: float, n_ops: float, peak_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops)


def clip_forward_flops(cfg: dict) -> float:
    """Multiply-adds × 2 of one image through the CLIP image tower: the
    patch embedding, per layer the qkv, attention (QKᵀ and PV), output
    and MLP products, and the final projection. Norms, softmax and the
    activation are left out (a few tenths of a percent)."""
    w, layers = cfg["width"], cfg["layers"]
    g = cfg["image_size"] // cfg["patch_size"]
    t = g * g + 1
    d_mlp = cfg["mlp_ratio"] * w
    patch = 2 * g * g * cfg["patch_size"] ** 2 * 3 * w
    per_layer = (2 * t * w * 3 * w        # qkv
                 + 2 * 2 * t * t * w      # QK^T and PV over all heads
                 + 2 * t * w * w          # out projection
                 + 2 * 2 * t * w * d_mlp)  # fc and proj
    return float(patch + layers * per_layer + 2 * w * cfg["embed_dim"])


def b1_call(cfg: dict, batch: int, dtype: str) -> tuple[float, float, float]:
    """(bytes, operations, bound seconds) of one B1 call (the attention
    core's forward) over ``batch`` images: the packed qkv [B, T, 3W] in,
    [B, T, W] out; 4·T²·W operations an image."""
    w = cfg["width"]
    g = cfg["image_size"] // cfg["patch_size"]
    t = g * g + 1
    n_bytes = batch * t * 4 * w * ITEMSIZE[dtype]
    n_ops = batch * 4 * t * t * w
    peak = PEAK_OPS["bfloat16"] if dtype == "bfloat16" else F32_3XTF32
    return float(n_bytes), float(n_ops), bound_s(n_bytes, n_ops, peak)


def b2_call(q: int, n: int, d: int) -> tuple[float, float, float]:
    """(bytes, operations, bound seconds) of one B2 call (the int8 scan):
    the int8 rows N·D and queries Q·D and the f32 penalty N·4 in, the f32
    scores Q·N·4 out; 2·Q·N·D integer operations."""
    n_bytes = n * d + q * d + 4 * n + 4 * q * n
    n_ops = 2 * q * n * d
    return float(n_bytes), float(n_ops), bound_s(n_bytes, n_ops,
                                                 PEAK_OPS["int8"])
