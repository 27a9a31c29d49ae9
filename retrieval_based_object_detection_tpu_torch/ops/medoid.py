"""Blocked medoid (kernel B4): total pairwise L2 distance per member.

The medoid strategy needs the row sums of the full N×N distance matrix
(32_create_delegate_vector.py:23-26). ``pairwise_distance_sums`` forms them
tile by tile with the Gram trick in f32 (d² clamped at 0, the diagonal
exactly 0), so the matrix never exists in device memory.

On CUDA tensors it launches the hand-written kernel in ``csrc/medoid.cu``
(only the tile pairs on or above the diagonal, in 3xTF32 on the tensor
cores), which takes N as it is (the ragged tile is masked in the kernel)
and sums in a fixed order, so the argmin is the same on every run. On CPU
tensors it runs ``pairwise_distance_sums_plain``, the same math over row
blocks with ``torch.matmul``, which tests and ``chip_smoke.py`` hold the
kernel against.
Both expect TF32 off (PyTorch's default for matmuls).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.ops.cuda_lib import (
    CudaLibrary,
)
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)

KERNEL = CudaLibrary("medoid", {
    "medoid_sums": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p],
})

_TILE = 128  # csrc/medoid.cu kTile
# The kernel's scratch holds one f32 slot per (row tile, row): N² / 128
# floats. Past this many bytes the launcher walks super-blocks of row tiles
# that fit (12,000 rows need 4.5 MB, 100,000 rows 313 MB).
_SCRATCH_BYTES = 64 << 20
_PLAIN_BLOCK = 1024  # rows per block of the plain version: O(1024 · N) memory


def pairwise_distance_sums_plain(vectors: torch.Tensor) -> torch.Tensor:
    """[N] sums of each row's L2 distances to all N rows, over row blocks
    of ``_PLAIN_BLOCK``."""
    x = vectors.to(torch.float32)
    n = x.shape[0]
    sq = torch.sum(x * x, dim=1)
    sums = torch.empty(n, dtype=torch.float32, device=x.device)
    for lo in range(0, n, _PLAIN_BLOCK):
        hi = min(lo + _PLAIN_BLOCK, n)
        d2 = sq[lo:hi, None] + sq[None, :] - 2.0 * (x[lo:hi] @ x.T)
        rows = torch.arange(hi - lo, device=x.device)
        d2[rows, rows + lo] = 0.0  # self-distances are exactly zero
        sums[lo:hi] = torch.sqrt(torch.clamp(d2, min=0.0)).sum(dim=1)
    return sums


def pairwise_distance_sums(vectors: torch.Tensor) -> torch.Tensor:
    """[N] f32: each row's total L2 distance to all N rows of ``vectors``
    ([N, D] f32)."""
    if vectors.device.type == "cpu":
        return pairwise_distance_sums_plain(vectors)
    if vectors.device.type != "cuda":
        raise ValueError(f"unsupported device {vectors.device}")
    if vectors.dim() != 2:
        raise ValueError(f"expected [N, D] rows, got {tuple(vectors.shape)}")
    if vectors.dtype != torch.float32:
        raise TypeError(f"f32 rows are required, got {vectors.dtype}")
    n, d = vectors.shape
    if d % 4 or d == 0:
        raise ValueError(f"dim={d}: the kernel reads rows in 16-byte "
                         "chunks (needs dim % 4 == 0, dim > 0)")
    if not vectors.is_contiguous() or vectors.data_ptr() % 16:
        raise ValueError("rows must be contiguous and 16-byte aligned")
    if n >= 2 ** 31 - _TILE:
        raise ValueError(f"{n} rows exceed the kernel's 32-bit row index")
    out = torch.empty(n, dtype=torch.float32, device=vectors.device)
    if n == 0:
        return out
    slots = min(-(-n // _TILE), max(1, _SCRATCH_BYTES // (4 * n)))
    sq = torch.empty(n, dtype=torch.float32, device=vectors.device)
    partial = torch.empty((slots, n), dtype=torch.float32,
                          device=vectors.device)
    KERNEL.launch("medoid_sums", vectors.device, vectors.data_ptr(),
                  sq.data_ptr(), partial.data_ptr(), out.data_ptr(), n, d,
                  slots)
    return out


def medoid_index(sums: torch.Tensor) -> int:
    """Row of the smallest distance sum (the first on a tie, as
    ``np.argmin``)."""
    return int(np.argmin(sums.cpu().numpy()))


def medoid_large(vectors: np.ndarray,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """Medoid of a large member set through ``pairwise_distance_sums`` on
    ``device``: the row with the least total distance to the others."""
    x = torch.from_numpy(np.ascontiguousarray(vectors, np.float32)
                         ).to(resolve_device(device))
    return vectors[medoid_index(pairwise_distance_sums(x))]
