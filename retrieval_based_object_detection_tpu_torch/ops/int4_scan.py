"""int4-packed gallery scan (kernel B3): half the bytes of the int8 scan.

``int4_scan_scores`` returns the ``[Q, N]`` f32 scores
``float(Σ_d q_i8[q, d] · w[n, d]) · scale[n] + penalty[n]``, where row n's
int4 values are packed two per byte by ``gallery.search.pack_rows_int4``:
byte ``packed[n, d]`` = ``16·hi + lo + 8`` holds ``w[n, d] = lo`` and
``w[n, d + D/2] = hi``. The integer dot is exact: |Σ| ≤ 127·8·D < 2²⁴
(checked), so its f32 conversion is exact, and the multiply and the add are
rounded one at a time on both sides, so kernel and plain version agree bit
for bit.

On CUDA tensors it launches the hand-written kernel in
``csrc/int4_scan.cu`` (any N; the ragged tile is masked in the kernel). On
CPU tensors it runs ``int4_scan_scores_plain``, which unpacks with shifts
and does an integer matmul; tests and ``chip_smoke.py`` hold the kernel
against it.
"""

from __future__ import annotations

import ctypes

import torch

from retrieval_based_object_detection_tpu_torch.ops.cuda_lib import (
    MAX_SMEM,
    CudaLibrary,
)

KERNEL = CudaLibrary("int4_scan", {
    "int4_scan": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
})

_ROWS = 128     # rows per block (csrc/int4_scan.cu kRows)
_QUERIES = 16   # queries per pass (kQueries)


def _check_exact(dim: int) -> None:
    if 127 * 8 * dim >= 1 << 24:
        raise ValueError(
            f"dim={dim}: int4 dots up to 127·8·{dim} are not exact in f32 "
            "(needs dim <= 16513)")


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, D/2] packed bytes → [N, D] int8 values in [-8, 7]: the low
    nibbles (biased by 8) are dims [0, D/2), the high nibbles — an
    arithmetic shift of the signed byte, i.e. floor(b / 16) — dims
    [D/2, D)."""
    lo = (packed & 15) - 8
    hi = packed >> 4
    return torch.cat([lo, hi], dim=1)


def int4_scan_scores_plain(q_i8: torch.Tensor, packed: torch.Tensor,
                           scales: torch.Tensor, penalty: torch.Tensor
                           ) -> torch.Tensor:
    """Unpack-and-matmul reference. int32 on the CPU; float64 on CUDA,
    which has no int32 matmul — exact, since every dot is below 2²⁴."""
    _check_exact(q_i8.shape[1])
    acc = torch.int32 if q_i8.device.type == "cpu" else torch.float64
    dots = q_i8.to(acc) @ unpack_int4(packed).to(acc).T
    return dots.to(torch.float32) * scales[None, :] + penalty[None, :]


def int4_scan_scores(q_i8: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, penalty: torch.Tensor
                     ) -> torch.Tensor:
    """[Q, N] f32 scale-compensated integer scores.

    ``q_i8`` [Q, D] int8 (queries quantised at scale 127), ``packed``
    [N, D/2] int8 (``pack_rows_int4``), ``scales`` [N] f32 per-row scales,
    ``penalty`` [N] f32 (0 for live rows, NEG_INF for masked ones)."""
    if q_i8.device.type == "cpu":
        return int4_scan_scores_plain(q_i8, packed, scales, penalty)
    if q_i8.device.type != "cuda":
        raise ValueError(f"unsupported device {q_i8.device}")
    Q, D = q_i8.shape
    N = packed.shape[0]
    if D % 2 or packed.shape[1] * 2 != D or scales.shape != (N,) \
            or penalty.shape != (N,):
        raise ValueError(f"shape mismatch: q {tuple(q_i8.shape)}, packed "
                         f"{tuple(packed.shape)}, scales "
                         f"{tuple(scales.shape)}, penalty "
                         f"{tuple(penalty.shape)}")
    _check_exact(D)
    if q_i8.dtype != torch.int8 or packed.dtype != torch.int8 \
            or scales.dtype != torch.float32 \
            or penalty.dtype != torch.float32:
        raise TypeError("int8 queries and packed rows and f32 scales and "
                        "penalty are required")
    if D % 32:
        raise ValueError(f"dim={D}: the kernel reads packed rows in "
                         "16-byte chunks (needs dim % 32 == 0)")
    smem = 16 * (_ROWS * (D // 32 + 1) + _QUERIES * D // 16)
    if smem > MAX_SMEM:
        raise ValueError(f"dim={D} needs {smem} bytes of shared memory, "
                         f"more than a block has ({MAX_SMEM})")
    for name, t in (("queries", q_i8), ("packed", packed),
                    ("scales", scales), ("penalty", penalty)):
        if t.device != q_i8.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{q_i8.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((Q, N), dtype=torch.float32, device=q_i8.device)
    if Q == 0 or N == 0:
        return out
    KERNEL.launch(
        "int4_scan", q_i8.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        penalty.data_ptr(), out.data_ptr(), Q, N, D,
        torch.cuda.current_stream(q_i8.device).cuda_stream)
    return out
