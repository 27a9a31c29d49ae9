"""int8 gallery scan (kernel B2): the million-row serving scan.

``int8_scan_scores`` returns the ``[Q, N]`` f32 scores
``q_i8 · gallery_i8ᵀ + penalty``. They are exact integers, bit-identical to
the int32 scores of ``gallery.search.int8_cosine_topk``, because
``127² · D < 2²⁴`` keeps every dot exact in f32 (checked: D ≤ 1040).

On CUDA tensors it launches the hand-written kernel in
``csrc/int8_scan.cu``, which multiplies on the int8 tensor cores
(``mma.sync.m16n8k32.s8``: 16 queries by 8 rows by 32 dims, exact in
int32; any N, any number of queries and any D that is a multiple of 16,
the ragged ends masked in the kernel). On CPU tensors it runs
``int8_scan_scores_plain``, an integer matmul, which tests and
``chip_smoke.py`` hold the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from retrieval_based_object_detection_tpu_torch.ops.cuda_lib import (
    MAX_SMEM,
    CudaLibrary,
)

KERNEL = CudaLibrary("int8_scan", {
    "int8_scan": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p],
})


def _smem_bytes(dim: int) -> int:
    """Shared memory of one block of ``csrc/int8_scan.cu``: 16 query rows
    padded to a multiple of 64 dims, rounded up to 128 bytes, plus 64 bytes
    of row padding, and 4 warps' 16 x 40 int32 stages."""
    dim_pad = -(-dim // 64) * 64
    return 16 * (-(-dim_pad // 128) * 128 + 64) + 4 * 4 * 16 * 40


def _check_exact(dim: int) -> None:
    if 127 * 127 * dim >= 1 << 24:
        raise ValueError(
            f"dim={dim}: int8 dots up to 127²·{dim} are not exact in f32 "
            "(needs dim <= 1040)")


def int8_scan_scores_plain(q_i8: torch.Tensor, gallery_i8: torch.Tensor,
                           penalty: torch.Tensor) -> torch.Tensor:
    """Integer-matmul reference. int32 on the CPU; float64 on CUDA —
    exact, since every dot is below 2²⁴, and independent of cuBLAS's int8
    path (``torch._int_mm``), which ``chip_smoke.py`` times as B2's
    yardstick."""
    _check_exact(q_i8.shape[1])
    acc = torch.int32 if q_i8.device.type == "cpu" else torch.float64
    dots = q_i8.to(acc) @ gallery_i8.to(acc).T
    return dots.to(torch.float32) + penalty[None, :]


def int8_scan_scores(q_i8: torch.Tensor, gallery_i8: torch.Tensor,
                     penalty: torch.Tensor) -> torch.Tensor:
    """[Q, N] f32 exact integer scores = q_i8 · gallery_i8ᵀ + penalty.

    ``q_i8`` [Q, D] int8, ``gallery_i8`` [N, D] int8 (the store's mirror),
    ``penalty`` [N] f32 (0 for live rows, NEG_INF for masked ones)."""
    if q_i8.device.type == "cpu":
        return int8_scan_scores_plain(q_i8, gallery_i8, penalty)
    if q_i8.device.type != "cuda":
        raise ValueError(f"unsupported device {q_i8.device}")
    Q, D = q_i8.shape
    N = gallery_i8.shape[0]
    _check_exact(D)
    if gallery_i8.shape[1] != D or penalty.shape != (N,):
        raise ValueError(f"shape mismatch: q {tuple(q_i8.shape)}, gallery "
                         f"{tuple(gallery_i8.shape)}, penalty "
                         f"{tuple(penalty.shape)}")
    if q_i8.dtype != torch.int8 or gallery_i8.dtype != torch.int8 \
            or penalty.dtype != torch.float32:
        raise TypeError("int8 queries and gallery and an f32 penalty "
                        "are required")
    if D % 16:
        raise ValueError(f"dim={D}: the kernel reads rows in 16-byte chunks")
    smem = _smem_bytes(D)
    if smem > MAX_SMEM:
        raise ValueError(f"dim={D} needs {smem} bytes of shared memory, "
                         f"more than a block has ({MAX_SMEM})")
    for name, t in (("queries", q_i8), ("gallery", gallery_i8),
                    ("penalty", penalty)):
        if t.device != q_i8.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{q_i8.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((Q, N), dtype=torch.float32, device=q_i8.device)
    if Q == 0 or N == 0:
        return out
    KERNEL.launch("int8_scan", q_i8.device, q_i8.data_ptr(),
                  gallery_i8.data_ptr(), penalty.data_ptr(), out.data_ptr(),
                  Q, N, D)
    return out
