"""Flash attention for long-sequence encoders: SAM's decomposed rel-pos
bias (kernel B6) and the plain non-causal form (kernel B7).

SAM's image encoder attends over 4,096 tokens in its global layers (a 64 ×
64 patch grid at 1024 px), where the [T, T] logits of one image and head
take 64 MB. ``flash_attention_2d_bias`` computes softmax online over key
tiles, with the bias

    bias(qi, kj) = bias_h[b, h, qi, kj // grid_w]
                 + bias_w[b, h, qi, kj % grid_w]

read from its per-query tables, so the logits never reach device memory.
``flash_attention`` is the same kernel with the bias off.

On CUDA tensors both launch the hand-written kernel in ``csrc/attention.cu``
(f32 or bf16 q/k/v, f32 bias tables, any T = grid_h · grid_w, head dims up to
128 in multiples of 8). On CPU tensors they run their plain versions
(``flash_attention_2d_bias_plain`` and ``flash_attention_plain``: f32 logits
plus bias, softmax, PV), which the tests hold against the JAX package's
kernels and ``chip_smoke.py`` holds the kernel against on the card. The
JAX functions' ``block_q``/``block_k`` arguments are TPU tiling choices and
are dropped; so are their asserts that T divides into such blocks.
``reference_attention`` is the JAX package's einsum oracle (p rounded to
q's dtype before the PV product).
"""

from __future__ import annotations

import ctypes

import torch

from retrieval_based_object_detection_tpu_torch.ops.cuda_lib import (
    MAX_SMEM,
    CudaLibrary,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaLibrary("attention", {
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "flash_attention_2d_bias_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _F, _I, _P],
})
B6 = "flash_attention_2d_bias_fwd"
B7 = "flash_attention_fwd"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
MAX_GROUPS = 65_535  # the grid's second dimension: batch × heads


def _logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 logits q·kᵀ·Dh^-1/2 (exact products for bf16 inputs)."""
    scale = q.shape[-1] ** -0.5
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √Dh) v in f32, cast once to q's dtype."""
    p = torch.softmax(_logits(q, k), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_2d_bias_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, bias_h: torch.Tensor,
                                  bias_w: torch.Tensor, grid_h: int,
                                  grid_w: int) -> torch.Tensor:
    """The einsum oracle of the JAX package's flash-bias tests: f32 logits
    plus the expanded bias, softmax, PV in f32, cast once to q's dtype."""
    B, H, T, _ = q.shape
    logits = _logits(q, k).reshape(B, H, T, grid_h, grid_w)
    logits = logits + bias_h[..., :, None] + bias_w[..., None, :]
    p = torch.softmax(logits.reshape(B, H, T, T), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain einsum attention as the JAX package's ``reference_attention``:
    p is rounded to q's dtype before the f32-accumulated PV product."""
    attn = torch.softmax(_logits(q, k), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", attn.float(),
                        v.float()).to(q.dtype)


def _threads_per_row(head_dim: int) -> int:
    return 1 if head_dim <= 32 else 2 if head_dim <= 64 else 4


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias_cols: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, Dh] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                        "the kernel takes one of float32 or bfloat16")
    B, H, _, Dh = q.shape
    if Dh % 8 or not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh}: the kernel takes multiples of 8 "
                         f"up to {MAX_HEAD_DIM}")
    if B * H > MAX_GROUPS:
        raise ValueError(f"batch × heads = {B * H} exceeds {MAX_GROUPS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    smem = 2 * 64 * _threads_per_row(Dh) * 36 * 4
    if bias_cols:
        smem += 64 * (bias_cols | 1) * 4
    if smem > MAX_SMEM:
        raise ValueError(
            f"grid_h + grid_w = {bias_cols}: a block's bias rows and K/V "
            f"tiles need {smem} bytes of shared memory, more than the "
            f"{MAX_SMEM} it has")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention of [B, H, T, Dh] q, k, v → [B, H, T, Dh] in q's
    dtype. CPU tensors take the plain version; CUDA tensors launch B7 or
    raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _check(q, k, v, 0)
    B, H, T, Dh = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    KERNEL.launch(B7, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), B * H, T, Dh, Dh ** -0.5,
                  _DTYPE_CODES[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


def flash_attention_2d_bias(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias_h: torch.Tensor,
                            bias_w: torch.Tensor, grid_h: int,
                            grid_w: int) -> torch.Tensor:
    """Attention of [B, H, T, Dh] q, k, v (T = grid_h · grid_w tokens in
    row-major grid order) with SAM's decomposed rel-pos bias from the f32
    tables ``bias_h`` [B, H, T, grid_h] and ``bias_w`` [B, H, T, grid_w] →
    [B, H, T, Dh] in q's dtype. CPU tensors take the plain version; CUDA
    tensors launch B6 or raise."""
    B, H, T, Dh = q.shape
    if T != grid_h * grid_w:
        raise ValueError(f"T={T} is not grid_h·grid_w = {grid_h}·{grid_w}")
    if bias_h.shape != (B, H, T, grid_h) or \
            bias_w.shape != (B, H, T, grid_w):
        raise ValueError(
            f"bias tables must be {(B, H, T, grid_h)} and "
            f"{(B, H, T, grid_w)}, got {tuple(bias_h.shape)} and "
            f"{tuple(bias_w.shape)}")
    if q.device.type == "cpu":
        return flash_attention_2d_bias_plain(q, k, v, bias_h, bias_w,
                                             grid_h, grid_w)
    _check(q, k, v, grid_h + grid_w)
    for name, t in (("bias_h", bias_h), ("bias_w", bias_w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the bias tables are f32")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    KERNEL.launch(B6, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  bias_h.data_ptr(), bias_w.data_ptr(), out.data_ptr(),
                  B * H, T, Dh, grid_h, grid_w, Dh ** -0.5,
                  _DTYPE_CODES[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
