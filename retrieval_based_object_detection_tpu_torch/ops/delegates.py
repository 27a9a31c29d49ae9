"""Delegate (representative) vector aggregation strategies, on the device.

The four strategies of 32_create_delegate_vector.py:9-26 with the JAX
package's math:

  average   — element-wise mean over members
  centroid  — the member closest (L2) to the mean
  weighted  — exp(-alpha * ||v - mean||)-weighted mean, alpha=2.0
  medoid    — the member with minimal total pairwise L2 distance

Each takes a padded [N, D] member matrix plus a validity mask. The medoid's
[N, N] distance matrix uses the Gram trick in f32 (the caller keeps TF32
off). Classes too large for it take the blocked medoid kernel
(``ops.medoid``).
"""

from __future__ import annotations

import torch

DELEGATE_TYPES = ("average", "centroid", "weighted", "medoid")
_BIG = 1e30


def _masked(vectors: torch.Tensor, mask: torch.Tensor | None):
    vectors = vectors.to(torch.float32)
    if mask is None:
        mask = torch.ones(vectors.shape[0], dtype=torch.bool,
                          device=vectors.device)
    count = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    return vectors, mask, count


def pairwise_l2(vectors: torch.Tensor) -> torch.Tensor:
    """Full [N, N] L2 distance matrix via the Gram trick."""
    sq = torch.sum(vectors * vectors, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (vectors @ vectors.T)
    # The Gram trick leaves small positive residuals on the diagonal;
    # self-distance is exactly zero.
    d2.fill_diagonal_(0.0)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _reductions(vectors, mask, count, alpha):
    avg = torch.where(mask[:, None], vectors, 0.0).sum(dim=0) / count
    dist_to_mean = torch.linalg.vector_norm(vectors - avg[None, :], dim=1)
    centroid = vectors[torch.argmin(torch.where(mask, dist_to_mean, _BIG))]
    w = torch.where(mask, torch.exp(-alpha * dist_to_mean), 0.0)
    # All-masked input → zeros, not NaN.
    weighted = torch.sum(
        vectors * (w / torch.clamp(w.sum(), min=1e-12))[:, None], dim=0)
    return {"average": avg, "centroid": centroid, "weighted": weighted}


def compute_partial_delegates(
    vectors: torch.Tensor, mask: torch.Tensor | None = None,
    alpha: float = 2.0,
) -> dict[str, torch.Tensor]:
    """average/centroid/weighted only — the O(n) strategies."""
    return _reductions(*_masked(vectors, mask), alpha)


def compute_all_delegates(
    vectors: torch.Tensor, mask: torch.Tensor | None = None,
    alpha: float = 2.0,
) -> dict[str, torch.Tensor]:
    """All four strategies, sharing one mean and one Gram matrix."""
    vectors, mask, count = _masked(vectors, mask)
    out = _reductions(vectors, mask, count, alpha)
    d = torch.where(mask[None, :], pairwise_l2(vectors), 0.0)
    totals = torch.where(mask, d.sum(dim=1), _BIG)
    out["medoid"] = vectors[torch.argmin(totals)]
    return out
