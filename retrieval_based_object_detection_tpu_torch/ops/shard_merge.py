"""Merge of the sharded int8 tier (P2): per query, the best ``k`` of the
union of S shards' rescored candidates, on the first shard's device.

Shard s hands over its candidates as ``[Q, r]`` f32 scores and ``[Q, r]``
int64 local rows; a candidate's global row is its local row plus
``s · rows_per``. The best ``k`` come in the order score descending, then
shard ascending, then position in the shard's list ascending: JAX's
``lax.top_k`` on each shard followed by ``lax.top_k`` over the shards'
lists gathered in shard order. Candidates at ``NEG_INF`` (masked rows)
keep that score and sort after every live one.

On CUDA tensors it launches the hand-written kernel in
``csrc/shard_merge.cu`` on the first shard's card, one block a query,
reading the other shards' candidates where they lie: over peer access
where ``torch.cuda.can_device_access_peer`` says the first card can read
that card, else from a copy to the first card made first. Before the merge
the first card's current stream waits for each other card's current
stream, and after it each of those waits for the merge, with no host sync.
It answers with a ``Merged``: the scores and rows, views of one buffer of
the kernel's, which ``Merged.host`` copies back at once. A merge counts one
launch in ``KERNEL.launches``. On CPU tensors it runs
``shard_merge_plain``, which tests and ``chip_smoke.py`` hold the kernel
against.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.ops.cuda_lib import (
    CudaLibrary,
)

_PTRS = ctypes.POINTER(ctypes.c_void_p)
KERNEL = CudaLibrary("shard_merge", {
    "shard_merge": [_PTRS, _PTRS, _PTRS, ctypes.POINTER(ctypes.c_int),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p],
    "shard_merge_enable_peer": [ctypes.c_int],
})

# csrc/shard_merge.cu: the shards one launch takes (kMaxShards); the grid
# holds the queries in its x dimension.
_MAX_SHARDS = 64


def shard_merge_plain(scores: list[torch.Tensor], rows: list[torch.Tensor],
                      rows_per: int, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` of a stable descending sort of the shards'
    candidates laid side by side in shard order, on the first shard's
    device → (scores [Q, k] f32, global rows [Q, k] int64). The stable sort
    keeps the earlier candidate among equal scores, as JAX's ``lax.top_k``
    over the gathered candidates does; ``torch.topk`` promises no order."""
    dev = scores[0].device
    flat_s = torch.cat([s.to(dev) for s in scores], dim=1)
    flat_r = torch.cat([r.to(dev) + sid * rows_per
                        for sid, r in enumerate(rows)], dim=1)
    order = torch.sort(flat_s, dim=1, descending=True, stable=True
                       ).indices[:, :k]
    return torch.gather(flat_s, 1, order), torch.gather(flat_r, 1, order)


def _split(buf: torch.Tensor, q: int, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scores [q, k] f32 and global rows [q, k] int64 in the kernel's
    buffer of 8-byte words: the rows, then the scores (padded to a
    word)."""
    nk = q * k
    rows = buf[:nk].view(q, k)
    scores = buf[nk: nk + (nk + 1) // 2].view(torch.float32)[:nk]
    return scores.view(q, k), rows


@dataclass(frozen=True)
class Merged:
    """``shard_merge``'s answer: the best k's scores [Q, k] f32 and global
    rows [Q, k] int64 on the first shard's device, and on CUDA the kernel's
    buffer (``buf``) that both are views of."""

    scores: torch.Tensor
    rows: torch.Tensor
    buf: torch.Tensor | None = None

    def host(self) -> tuple[np.ndarray, np.ndarray]:
        """The scores and rows as host arrays: on CUDA by one copy of the
        buffer, so one synchronise."""
        if self.buf is None:
            return self.scores.cpu().numpy(), self.rows.cpu().numpy()
        q, k = self.rows.shape
        s, i = _split(self.buf[: q * k + (q * k + 1) // 2].cpu(), q, k)
        return s.numpy(), i.numpy()


@functools.lru_cache(maxsize=None)
def _peer(first: int, other: int) -> bool:
    """Whether card ``first`` reads card ``other``'s memory: asked of CUDA
    once a pair, and, where it can, switched on (through a copy, so that
    PyTorch's own record of the pair says so too)."""
    if not torch.cuda.can_device_access_peer(first, other):
        return False
    torch.zeros(1, device=f"cuda:{first}").to(f"cuda:{other}")
    with torch.cuda.device(first):
        rc = KERNEL.load().shard_merge_enable_peer(other)
    if rc != 0:
        raise RuntimeError(f"shard_merge: peer access from cuda:{first} to "
                           f"cuda:{other}: CUDA error {rc}")
    return True


def shard_merge(scores: list[torch.Tensor], rows: list[torch.Tensor],
                rows_per: int, k: int) -> Merged:
    """The best ``k`` of S shards' candidates (shard s's ``scores[s]``
    [Q, r] f32 and local ``rows[s]`` [Q, r] int64, on its device) → their
    scores [Q, k] f32 and global rows [Q, k] int64 on the first shard's
    device; ``0 <= k <= S·r``.

    On CUDA the candidates must be contiguous and are read in place until
    the merge has run: the first card's stream waits for each other card's
    current stream, and each of those then waits for the merge."""
    if not scores or len(scores) != len(rows):
        raise ValueError(f"{len(scores)} score lists for {len(rows)} row "
                         "lists")
    if scores[0].dim() != 2:
        raise ValueError(f"candidates must be [Q, r], not "
                         f"{tuple(scores[0].shape)}")
    q, r = scores[0].shape
    if any(t.shape != (q, r) for t in (*scores, *rows)):
        raise ValueError("every shard's candidates must be "
                         f"[{q}, {r}]: {[tuple(t.shape) for t in scores]}, "
                         f"{[tuple(t.shape) for t in rows]}")
    if not 0 <= k <= len(scores) * r:
        raise ValueError(f"k={k} outside 0..{len(scores) * r}")
    dev = scores[0].device
    if all(t.device.type == "cpu" for t in (*scores, *rows)):
        return Merged(*shard_merge_plain(scores, rows, rows_per, k))
    if any(t.device.type != "cuda" for t in (*scores, *rows)):
        raise ValueError("unsupported devices "
                         f"{sorted({str(t.device) for t in scores})}")
    if any(s.dtype != torch.float32 or i.dtype != torch.int64
           or not s.is_contiguous() or not i.is_contiguous()
           for s, i in zip(scores, rows)):
        raise TypeError("contiguous f32 scores and int64 rows are required")
    if len(scores) > _MAX_SHARDS:
        raise ValueError(f"{len(scores)} shards: at most {_MAX_SHARDS}")
    nk = q * k
    buf = torch.empty(nk + (nk + 1) // 2 + nk, dtype=torch.int64,
                      device=dev)
    if nk:
        scores, rows = list(scores), list(rows)
        for s, (sc, ix) in enumerate(zip(scores, rows)):
            if sc.device != dev and not _peer(dev.index, sc.device.index):
                scores[s] = sc.to(dev, non_blocking=True)
                rows[s] = ix.to(dev, non_blocking=True)
        n = len(scores)
        KERNEL.launch(
            "shard_merge", dev,
            (ctypes.c_void_p * n)(*(t.data_ptr() for t in scores)),
            (ctypes.c_void_p * n)(*(t.data_ptr() for t in rows)),
            (ctypes.c_void_p * n)(*(
                torch.cuda.current_stream(t.device).cuda_stream
                for t in scores)),
            (ctypes.c_int * n)(*(t.device.index for t in scores)),
            n, q, r, rows_per, k, buf.data_ptr())
    return Merged(*_split(buf, q, k), buf)

