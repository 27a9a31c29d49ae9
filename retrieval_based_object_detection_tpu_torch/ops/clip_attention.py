"""Attention core of CLIP's short-sequence ViT (kernel B1), forward only.

``clip_attention_core`` takes the packed ``[B, T, 3W]`` qkv exactly as the
input projection emits it and returns the merged ``[B, T, W]`` attention
output (before the out-projection). On a CUDA tensor it launches the
hand-written kernel in ``csrc/clip_attention.cu`` (f32 or bf16); on a CPU
tensor it runs ``clip_attention_core_plain``, the einsum path of the JAX
tower, which tests and ``chip_smoke.py`` hold the kernel against.

The recompute-based backward (the JAX package's ``_attn_core_bwd_kernel``)
is not ported yet: the port serves, it does not train.
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
})

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def clip_attention_core_plain(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Einsum reference: logits and softmax in f32, p cast to the input
    dtype before the PV product, which accumulates in f32."""
    B, T, threeW = qkv.shape
    W = threeW // 3
    D = W // heads
    q, k, v = (t.reshape(B, T, heads, D).transpose(1, 2)
               for t in qkv.split(W, dim=-1))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits * (D ** -0.5)
    attn = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", attn.float(), v.float())
    return out.to(qkv.dtype).transpose(1, 2).reshape(B, T, W)


def clip_attention_core(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """→ [B, T, W] merged attention output of the packed [B, T, 3W] qkv.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if qkv.device.type == "cpu":
        return clip_attention_core_plain(qkv, heads)
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
    B, T, threeW = qkv.shape
    W = threeW // 3
    D = W // heads
    smem = (3 * T * (D + 1) + T * (T + 1)) * 4
    if smem > MAX_SMEM:
        raise ValueError(
            f"T={T}, D={D}: one head's q, k, v and logits need {smem} bytes "
            f"of shared memory, more than the {MAX_SMEM} a block has")
    out = torch.empty((B, T, W), dtype=qkv.dtype, device=qkv.device)
    if B == 0 or T == 0:
        return out
    KERNEL.launch(
        "clip_attention_fwd", qkv.data_ptr(), out.data_ptr(), B, T, heads, D,
        D ** -0.5, _DTYPE_CODES[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    return out
