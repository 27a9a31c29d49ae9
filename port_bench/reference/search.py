"""Exact filtered cosine top-k, in plain PyTorch.

Rows and queries are normalised, every score is an f32 dot product with
TF32 off, rows outside the filter are excluded, and the k best are
taken. ``dtype=torch.bfloat16`` is the control: rows, queries and scores
in bf16.
"""

from __future__ import annotations

import torch

from reference.clip import exact_f32


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def topk(rows: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor,
         k: int, dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """rows [N, D], queries [Q, D], mask [N] bool → (scores [Q, k] f32,
    row indices [Q, k]); fewer than k matches leave -inf scores."""
    with torch.no_grad(), exact_f32():
        r = unit(rows.float()).to(dtype)
        q = unit(queries.float()).to(dtype)
        scores = (q @ r.T).float()
        scores = torch.where(mask[None, :], scores, float("-inf"))
        return torch.topk(scores, min(k, rows.shape[0]), dim=1)


def scores_of(rows: torch.Tensor, queries: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """f32 cosine of each query with the rows ``idx`` [Q, k] names."""
    with torch.no_grad(), exact_f32():
        r = unit(rows[idx.reshape(-1)].float()).reshape(*idx.shape, -1)
        q = unit(queries.float())
        return torch.einsum("qd,qkd->qk", q, r)
