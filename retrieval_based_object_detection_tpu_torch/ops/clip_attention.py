"""Attention core of CLIP's short-sequence ViT: forward (kernel B1) and
backward (kernel B5).

``clip_attention_core`` takes the packed ``[B, T, 3W]`` qkv exactly as the
input projection emits it and returns the merged ``[B, T, W]`` attention
output (before the out-projection). On a CUDA tensor it launches the
hand-written forward in ``csrc/clip_attention.cu`` (f32 or bf16); on a CPU
tensor it runs ``clip_attention_core_plain``, the einsum path of the JAX
tower, which tests and ``chip_smoke.py`` hold the kernel against.

When a gradient is needed it goes through ``AttentionCore``, a
``torch.autograd.Function`` that mirrors the JAX package's ``custom_vjp``:
its forward is B1 and saves nothing but ``qkv``; its backward rebuilds the
probabilities and returns ``dqkv`` in the packed layout, through the
hand-written backward (B5) for CUDA tensors and
``clip_attention_core_bwd_plain`` (the same formulas in f32 torch ops) for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from retrieval_based_object_detection_tpu_torch.ops.cuda_lib import (
    MAX_SMEM,
    CudaLibrary,
)

KERNEL = CudaLibrary("clip_attention", {
    "clip_attention_fwd": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "clip_attention_bwd": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_int,
                           ctypes.c_void_p],
})

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, W = t.shape
    return t.reshape(B, T, heads, W // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    B, H, T, D = t.shape
    return t.transpose(1, 2).reshape(B, T, H * D)


def clip_attention_core_plain(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Einsum reference: logits and softmax in f32, p cast to the input
    dtype before the PV product, which accumulates in f32."""
    W = qkv.shape[2] // 3
    D = W // heads
    q, k, v = (_split_heads(t, heads) for t in qkv.split(W, dim=-1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits * (D ** -0.5)
    attn = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", attn.float(), v.float())
    return _merge_heads(out.to(qkv.dtype))


def clip_attention_core_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                                  heads: int) -> torch.Tensor:
    """The recompute backward of the JAX package's ``_attn_core_bwd_kernel``
    in f32 torch ops, cast once to qkv's dtype:
    dv = pᵀ·g, dp = g·vᵀ, dl = p∘(dp − Σrow(dp∘p)), dq = dl·k·s, dk = dlᵀ·q·s.
    """
    W = qkv.shape[2] // 3
    scale = (W // heads) ** -0.5
    q, k, v = (_split_heads(t, heads).float() for t in qkv.split(W, dim=-1))
    g = _split_heads(dout, heads).float()
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) * scale, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", dl, k) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", dl, q) * scale
    return torch.cat([_merge_heads(dq), _merge_heads(dk), _merge_heads(dv)],
                     dim=-1).to(qkv.dtype)


def _check(qkv: torch.Tensor, heads: int, smem_floats: int) -> None:
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.ndim != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"qkv must be [B, T, 3*heads*D], got "
                         f"{tuple(qkv.shape)} with heads={heads}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv dtype {qkv.dtype}: the kernel takes float32 "
                        "or bfloat16")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if smem_floats * 4 > MAX_SMEM:
        T, D = qkv.shape[1], qkv.shape[2] // (3 * heads)
        raise ValueError(
            f"T={T}, D={D}: one head needs {smem_floats * 4} bytes of shared "
            f"memory, more than the {MAX_SMEM} a block has")


def _forward(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """B1 on a CUDA tensor, the plain version on a CPU tensor."""
    if qkv.device.type == "cpu":
        return clip_attention_core_plain(qkv, heads)
    B, T, threeW = qkv.shape
    D = threeW // (3 * heads)
    _check(qkv, heads, 3 * T * (D + 1) + T * (T + 1))
    out = torch.empty((B, T, threeW // 3), dtype=qkv.dtype,
                      device=qkv.device)
    if B == 0 or T == 0:
        return out
    KERNEL.launch(
        "clip_attention_fwd", qkv.data_ptr(), out.data_ptr(), B, T, heads, D,
        D ** -0.5, _DTYPE_CODES[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    return out


def clip_attention_core_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                            heads: int) -> torch.Tensor:
    """→ [B, T, 3W] dqkv of the packed qkv for the output gradient ``dout``
    [B, T, W], in qkv's dtype. CPU tensors take the plain version; CUDA
    tensors launch B5 or raise."""
    if qkv.device.type == "cpu":
        return clip_attention_core_bwd_plain(qkv, dout, heads)
    B, T, threeW = qkv.shape
    D = threeW // (3 * heads)
    _check(qkv, heads, 4 * T * (D + 1) + 2 * T * (T + 1))
    if dout.shape != (B, T, threeW // 3) or dout.dtype != qkv.dtype \
            or dout.device != qkv.device or not dout.is_contiguous():
        raise ValueError(
            f"dout must be a contiguous {(B, T, threeW // 3)} {qkv.dtype} "
            f"tensor on {qkv.device}, got {tuple(dout.shape)} {dout.dtype} "
            f"on {dout.device}")
    dqkv = torch.empty_like(qkv)
    if B == 0 or T == 0:
        return dqkv
    KERNEL.launch(
        "clip_attention_bwd", qkv.data_ptr(), dout.data_ptr(),
        dqkv.data_ptr(), B, T, heads, D, D ** -0.5, _DTYPE_CODES[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    return dqkv


class AttentionCore(torch.autograd.Function):
    """B1 forward, B5 backward; saves only ``qkv`` (the ``custom_vjp`` of
    the JAX package's ``_attn_core``)."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        return _forward(qkv, heads)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, = ctx.saved_tensors
        return clip_attention_core_bwd(qkv, dout.contiguous(), ctx.heads), None


def clip_attention_core(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """→ [B, T, W] merged attention output of the packed [B, T, 3W] qkv.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. Where autograd needs a gradient of ``qkv`` the call goes through
    ``AttentionCore``, so the backward is B5 (or its plain version)."""
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qkv.device}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        return AttentionCore.apply(qkv, heads)
    return _forward(qkv, heads)
