"""Device-side cosine top-k search over the padded gallery.

The gallery is a padded tensor resident on the device, and a query batch is
answered by one matmul plus a masked top-k. Payload filters arrive as
boolean row masks.

Tiers:
  * ``masked_cosine_topk(exact=True)`` — f32 (the caller keeps TF32 off).
  * ``masked_cosine_topk(exact=False)`` — bf16 rows and queries, f32
    scores.
  * ``masked_metric_topk`` — the non-cosine metrics (dot, euclid,
    manhattan) over raw rows; ``masked_cosine_scores`` — the full masked
    cosine matrix. Their exact products are f32 under the same rule as the
    exact cosine tier: the caller keeps TF32 off.
  * ``int8_scan_topk`` — the int8 scan (kernel B2 on CUDA) → top
    ``rescore`` candidates → exact f32 rescore. ``int8_cosine_topk`` is its
    exact twin over a plain integer matmul.
  * ``int4_scan_topk`` — the same over rows packed two 4-bit dims per byte
    with a per-row scale (``pack_rows_int4``; kernel B3 on CUDA): half the
    int8 scan's bytes, and a top-k set that is approximate at the margin.
    ``int4_cosine_topk`` is its exact twin over a plain unpack-and-matmul.

``torch.topk`` takes the place of JAX's ``approx_max_k`` and ``lax.top_k``.
It promises no order among equal scores, so callers compare top-k by scores
or id sets.
"""

from __future__ import annotations

import torch

from retrieval_based_object_detection_tpu_torch.ops.int4_scan import (
    int4_scan_scores,
    int4_scan_scores_plain,
)
from retrieval_based_object_detection_tpu_torch.ops.int8_scan import (
    int8_scan_scores,
    int8_scan_scores_plain,
)

NEG_INF = -1e30

# Rows per |q - g| pass of the manhattan metric (JAX's chunk).
_L1_CHUNK = 1024


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalisation in float32."""
    x = x.to(torch.float32)
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def masked_cosine_topk(
    queries: torch.Tensor,  # [Q, D] unnormalised
    gallery: torch.Tensor,  # [N, D] padded
    mask: torch.Tensor,     # [N] bool — valid AND filter-matching rows
    k: int,
    exact: bool = True,
    gallery_normalized: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k], row indices [Q, k]) of the best cosine matches.

    Rows where ``mask`` is False score NEG_INF and enter the top-k only
    when fewer than k rows match (callers check scores > NEG_INF/2)."""
    q = l2_normalize(queries)
    g = gallery if gallery_normalized else l2_normalize(gallery)
    if exact:
        scores = q @ g.to(torch.float32).T
    else:
        # bf16 operands, f32 scores: a bf16 product is exact in f32, so
        # this is the f32-accumulated bf16 dot of the JAX tier.
        scores = (q.to(torch.bfloat16).to(torch.float32)
                  @ g.to(torch.bfloat16).to(torch.float32).T)
    scores = torch.where(mask[None, :], scores, NEG_INF)
    return torch.topk(scores, k, dim=1)


def _dots_f32(q: torch.Tensor, g: torch.Tensor, exact: bool
              ) -> torch.Tensor:
    """[Q, N] f32 dot products of f32 queries and rows (any float dtype).

    ``exact=True`` is JAX's ``Precision.HIGHEST``: an f32 product, with
    TF32 off as for the exact cosine tier (the caller keeps it off, which
    is PyTorch's default). ``exact=False`` multiplies bf16-rounded operands
    with f32 scores, as the bf16 cosine tier does."""
    if exact:
        return q @ g.to(torch.float32).T
    return (q.to(torch.bfloat16).to(torch.float32)
            @ g.to(torch.bfloat16).to(torch.float32).T)


def masked_metric_topk(
    queries: torch.Tensor,  # [Q, D] raw (NOT normalised)
    gallery: torch.Tensor,  # [N, D] raw rows, padded
    mask: torch.Tensor,     # [N] bool
    k: int,
    distance: str,          # "dot" | "euclid" | "manhattan"
    exact: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k for the non-cosine metrics the reference's collection manager
    offers (qdrant_manager.py:61-65). Scores are higher-is-better: the dot
    product, or the NEGATIVE L2 / L1 distance. euclid expands
    ‖q‖² − 2q·g + ‖g‖²; manhattan has no matmul form and walks the rows in
    chunks of |q − g| sums (``exact`` does not change it)."""
    q = queries.to(torch.float32)
    g = gallery.to(torch.float32)
    if distance == "manhattan":
        scores = torch.empty((q.shape[0], g.shape[0]), dtype=torch.float32,
                             device=g.device)
        for lo in range(0, g.shape[0], _L1_CHUNK):
            c = g[lo: lo + _L1_CHUNK]
            scores[:, lo: lo + len(c)] = -torch.sum(
                torch.abs(q[:, None, :] - c[None, :, :]), dim=-1)
    elif distance in ("dot", "euclid"):
        scores = _dots_f32(q, g, exact)
        if distance == "euclid":
            q_sq = torch.sum(q * q, dim=1, keepdim=True)
            g_sq = torch.sum(g * g, dim=1)
            d2 = torch.clamp(q_sq - 2.0 * scores + g_sq[None, :], min=0.0)
            scores = -torch.sqrt(d2)
    else:
        raise ValueError(f"unsupported distance: {distance}")
    scores = torch.where(mask[None, :], scores, NEG_INF)
    return torch.topk(scores, k, dim=1)


def masked_cosine_scores(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    mask: torch.Tensor,
    exact: bool = True,
) -> torch.Tensor:
    """Full [Q, N] masked cosine similarity matrix (for score
    distributions); masked rows score NEG_INF."""
    q = l2_normalize(queries)
    g = l2_normalize(gallery)
    scores = q @ g.T  # f32 either way; ``exact`` only names JAX's precision
    return torch.where(mask[None, :], scores, NEG_INF)


def pad_rows(n: int, multiple: int = 256) -> int:
    """Round a row count up to a multiple (room for appends in place)."""
    return max(multiple, -(-n // multiple) * multiple)


def quantize_rows_int8(normalized_rows: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantisation of L2-normalised rows (scale 1/127).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(normalized_rows * 127.0), -127, 127
                       ).to(torch.int8)


def _rescore(qn, gallery_rows, cand_s, cand_i, k, live):
    """Rescore the candidates against ``gallery_rows`` (f32, or the
    capacity tier's bf16 mirror) and keep the best ``k``. bf16 rows meet a
    bf16-rounded query, multiplied in f32 with f32 scores, as JAX's
    ``preferred_element_type=jnp.float32`` does: a torch bf16 einsum would
    round the scores themselves to bf16."""
    rows = gallery_rows[cand_i]  # [Q, r, D]
    q = qn.to(rows.dtype).to(torch.float32)
    exact = torch.einsum("qd,qrd->qr", q, rows.to(torch.float32))
    exact = torch.where(live, exact, NEG_INF)
    best_s, pos = torch.topk(exact, k, dim=1)
    return best_s, torch.gather(cand_i, 1, pos)


def int8_scan_topk(
    queries: torch.Tensor,      # [Q, D] unnormalised f32
    gallery_i8: torch.Tensor,   # [N, D] int8 of normalised rows
    gallery_f32: torch.Tensor,  # [N, D] normalised f32 (for exact rescoring)
    mask: torch.Tensor,         # [N] bool
    k: int,
    rescore: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Million-row serving scan: int8 scores (kernel B2, in-kernel filter
    penalty) → top-``rescore`` candidates → exact f32 rescore."""
    N = gallery_f32.shape[0]
    qn = l2_normalize(queries)
    q_i8 = quantize_rows_int8(qn)
    penalty = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
    scores = int8_scan_scores(q_i8, gallery_i8, penalty)
    cand_s, cand_i = torch.topk(scores, min(rescore, N), dim=1)
    return _rescore(qn, gallery_f32, cand_s, cand_i, k,
                    cand_s > NEG_INF / 2)


def int8_cosine_topk(
    queries: torch.Tensor,      # [Q, D] unnormalised f32
    gallery_i8: torch.Tensor,   # [N, D] int8 of normalised rows
    gallery_f32: torch.Tensor,  # [N, D] normalised f32 (for rescoring)
    mask: torch.Tensor,         # [N] bool
    k: int,
    rescore: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact twin of ``int8_scan_topk``: the same integer scores from a
    plain integer matmul, masked with an int32 sentinel, → top-``rescore``
    candidates → exact f32 rescore."""
    qn = l2_normalize(queries)
    q_i8 = quantize_rows_int8(qn)
    no_penalty = torch.zeros(gallery_i8.shape[0], dtype=torch.float32,
                             device=gallery_i8.device)
    sentinel = -(2 ** 31) + 1
    scores = int8_scan_scores_plain(q_i8, gallery_i8, no_penalty
                                    ).to(torch.int64)
    scores = torch.where(mask[None, :], scores, sentinel)
    cand_s, cand_i = torch.topk(scores, min(rescore, gallery_i8.shape[0]),
                                dim=1)
    return _rescore(qn, gallery_f32, cand_s, cand_i, k, cand_s > sentinel)


def pack_rows_int4(normalized_rows: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int4 quantisation, packed two dims per byte.

    Returns (packed [N, D/2] int8, scales [N] f32), bit for bit the JAX
    package's: s = max(max|row|, 1e-12) / 7, q = clip(round(row / s), -8, 7)
    (a true division and round-half-even, as ``jnp`` does), and dim d and
    dim d + D/2 share byte d as ``16·hi + lo + 8``, formed in int16 before
    the cast. Requires even D."""
    n, d = normalized_rows.shape
    if d % 2:
        raise ValueError(f"dim={d}: two dims pack per byte (needs even dim)")
    s = torch.clamp(normalized_rows.abs().amax(dim=1, keepdim=True),
                    min=1e-12) / 7.0
    q = torch.clamp(torch.round(normalized_rows / s), -8, 7).to(torch.int16)
    lo, hi = q[:, : d // 2], q[:, d // 2:]
    return (hi * 16 + lo + 8).to(torch.int8), s[:, 0]


def int4_scan_topk(
    queries: torch.Tensor,      # [Q, D] unnormalised f32
    packed: torch.Tensor,       # [N, D/2] int8 (pack_rows_int4)
    scales: torch.Tensor,       # [N] f32 per-row scales
    gallery_f32: torch.Tensor,  # [N, D] normalised rows for rescoring —
    #                             f32 (exact), or bf16 (the capacity tier)
    mask: torch.Tensor,         # [N] bool
    k: int,
    rescore: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Half-bandwidth serving scan: scale-compensated int4 scores (kernel
    B3, in-kernel filter penalty) → top-``rescore`` candidates → rescore
    against the full-precision rows. Hit scores are exact cosines with f32
    rows (with bf16 rows, the bf16 values' cosine); the top-k SET is
    approximate at the margin (4-bit resolution)."""
    N = gallery_f32.shape[0]
    qn = l2_normalize(queries)
    q_i8 = quantize_rows_int8(qn)
    penalty = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
    scores = int4_scan_scores(q_i8, packed, scales, penalty)
    cand_s, cand_i = torch.topk(scores, min(rescore, N), dim=1)
    return _rescore(qn, gallery_f32, cand_s, cand_i, k,
                    cand_s > NEG_INF / 2)


def int4_cosine_topk(
    queries: torch.Tensor,      # [Q, D] unnormalised f32
    packed: torch.Tensor,       # [N, D/2] int8 (pack_rows_int4)
    scales: torch.Tensor,       # [N] f32
    gallery_f32: torch.Tensor,  # [N, D] normalised f32
    mask: torch.Tensor,         # [N] bool
    k: int,
    rescore: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact twin of ``int4_scan_topk``: the same scores from a plain
    unpack-and-matmul, masked afterwards, → top-``rescore`` candidates →
    exact f32 rescore. The yardstick that tests and ``chip_smoke.py`` hold
    the scan path against; ``Gallery.search`` does not call it."""
    qn = l2_normalize(queries)
    q_i8 = quantize_rows_int8(qn)
    no_penalty = torch.zeros(packed.shape[0], dtype=torch.float32,
                             device=packed.device)
    scores = int4_scan_scores_plain(q_i8, packed, scales, no_penalty)
    scores = torch.where(mask[None, :], scores, NEG_INF)
    cand_s, cand_i = torch.topk(scores, min(rescore, packed.shape[0]), dim=1)
    return _rescore(qn, gallery_f32, cand_s, cand_i, k,
                    cand_s > NEG_INF / 2)
