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
    ``rescore`` candidates (the candidate select, ``ops/int8_select.py``:
    exact, with ``lax.top_k``'s tie rule) → exact f32 rescore.
    ``int8_cosine_topk`` is its exact twin over a plain integer matmul.
    ``Int8ScanGraphs`` serves it on CUDA: the chain captured once per card
    and query bucket as a CUDA graph and replayed.
  * ``int4_scan_topk`` — the same over rows packed two 4-bit dims per byte
    with a per-row scale (``pack_rows_int4``; kernel B3 on CUDA): half the
    int8 scan's bytes, and a top-k set that is approximate at the margin.
    ``int4_cosine_topk`` is its exact twin over a plain unpack-and-matmul.

``torch.topk`` takes the place of JAX's ``approx_max_k`` and ``lax.top_k``
elsewhere. It promises no order among equal scores, so callers compare
top-k by scores or id sets.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from dataclasses import dataclass

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.ops.int4_scan import (
    int4_scan_scores,
    int4_scan_scores_plain,
)
from retrieval_based_object_detection_tpu_torch.ops.int8_scan import (
    KERNEL as B2,
    int8_scan_scores,
    int8_scan_scores_plain,
)
from retrieval_based_object_detection_tpu_torch.ops.int8_select import (
    KERNEL as SELECT,
    int8_select,
)
from retrieval_based_object_detection_tpu_torch.utils import (
    logging as tracer,
)

NEG_INF = -1e30

# Rows per |q - g| pass of the manhattan metric (JAX's chunk).
_L1_CHUNK = 1024


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, always as a copy: ``torch.from_numpy``
    aliases host memory, and on the CPU ``.to(device)`` keeps the alias,
    so a later write to a reused staging buffer or a live store buffer
    would reach the device value."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


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
    scores = torch.where(mask[None, :], _dots_f32(q, g, exact), NEG_INF)
    return torch.topk(scores, k, dim=1)


def _dots_f32(q: torch.Tensor, g: torch.Tensor, exact: bool
              ) -> torch.Tensor:
    """[Q, N] f32 dot products of f32 queries and rows (any float dtype).

    ``exact=True`` is JAX's ``Precision.HIGHEST``: an f32 product, with
    TF32 off as for the exact cosine tier (the caller keeps it off, which
    is PyTorch's default). ``exact=False`` multiplies bf16-rounded operands
    with f32 scores: a bf16 product is exact in f32, so this is the
    f32-accumulated bf16 dot of the JAX tier."""
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


def _rescored(qn, gallery_rows, cand_i, live):
    """[Q, r] exact f32 scores of the candidates against ``gallery_rows``
    (f32, or the capacity tier's bf16 mirror), NEG_INF where not ``live``.
    bf16 rows meet a bf16-rounded query, multiplied in f32 with f32 scores,
    as JAX's ``preferred_element_type=jnp.float32`` does: a torch bf16
    einsum would round the scores themselves to bf16."""
    rows = gallery_rows[cand_i]  # [Q, r, D]
    q = qn.to(rows.dtype).to(torch.float32)
    exact = torch.einsum("qd,qrd->qr", q, rows.to(torch.float32))
    return torch.where(live, exact, NEG_INF)


def _best(exact, cand_i, k):
    """The best ``k`` of rescored candidates → (scores, rows)."""
    best_s, pos = torch.topk(exact, k, dim=1)
    return best_s, torch.gather(cand_i, 1, pos)


def _rescore(qn, gallery_rows, cand_i, k, live):
    """Rescore the candidates (``_rescored``) and keep the best ``k``."""
    return _best(_rescored(qn, gallery_rows, cand_i, live), cand_i, k)


def _int8_candidates(queries, gallery_i8, gallery_f32, mask, rescore):
    """``int8_scan_topk`` up to its last selection: the top ``rescore``
    rows by int8 score (kernel B2, in-kernel filter penalty; the candidate
    select), rescored exactly → (exact scores [Q, r], rows [Q, r])."""
    N = gallery_f32.shape[0]
    qn = l2_normalize(queries)
    q_i8 = quantize_rows_int8(qn)
    penalty = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
    scores = int8_scan_scores(q_i8, gallery_i8, penalty)
    cand_s, cand_i = int8_select(scores, min(rescore, N))
    return _rescored(qn, gallery_f32, cand_i, cand_s > NEG_INF / 2), cand_i


def int8_scan_topk(
    queries: torch.Tensor,      # [Q, D] unnormalised f32
    gallery_i8: torch.Tensor,   # [N, D] int8 of normalised rows
    gallery_f32: torch.Tensor,  # [N, D] normalised f32 (for exact rescoring)
    mask: torch.Tensor,         # [N] bool
    k: int,
    rescore: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Million-row serving scan: int8 scores (kernel B2, in-kernel filter
    penalty) → top-``rescore`` candidates (the candidate select) → exact
    f32 rescore."""
    return _best(*_int8_candidates(queries, gallery_i8, gallery_f32, mask,
                                   rescore), k)


def rescore_depth(k: int, rows: int) -> int:
    """Candidates the int8 and int4 tiers rescore for a top-``k`` over
    ``rows`` rows: eight per hit, at least 256, at most the rows."""
    return min(max(8 * k, 256), rows)


# The query counts the int8 chain is captured for. A call's queries go into
# the first of these that holds them (the rows past them are left over from
# earlier calls: each query row's results depend on that row alone), so a
# card holds at most this many graphs per pair of mirrors, whatever shapes
# the callers send. More queries, or more candidates than
# GRAPH_MAX_RESCORE (k > 32 under ``rescore_depth``), run eagerly.
GRAPH_QUERIES = (1, 2, 4, 8, 16, 32, 64)
GRAPH_MAX_RESCORE = 256

# CUDA captures one graph at a time in a process.
_CAPTURE_LOCK = threading.Lock()


@dataclass
class _Int8Graph:
    """One captured chain: the graph, its static inputs and outputs on the
    card, the launches it recorded (library → function → launches: B2's and
    the candidate select's), and the mirrors it reads (held, so that they
    outlive it)."""

    graph: torch.cuda.CUDAGraph
    queries: torch.Tensor   # [bucket, D] f32
    mask: torch.Tensor      # [N] bool
    exact: torch.Tensor     # [bucket, r] f32, the rescored candidates
    rows: torch.Tensor      # [bucket, r] int64
    recorded: dict
    mirrors: tuple


@dataclass
class _Card:
    """What one card's graphs share: the lock that keeps their replays from
    interleaving, and their memory pools, one per pair of mirrors."""

    lock: threading.Lock
    pools: dict


class Int8ScanGraphs:
    """``int8_scan_topk`` on CUDA as CUDA graphs, one per card and query
    bucket (``GRAPH_QUERIES``).

    The eager chain is a few dozen small launches from the host
    (normalise, quantise, penalty, B2, the candidate select, the rescore);
    a replay is one. A call copies its queries and row mask into the graph's
    static inputs, replays it, and takes the best ``k`` of the static
    rescored candidates eagerly (two launches), so ``k`` is no part of the
    graph. The first call of a bucket runs the chain eagerly on a side
    stream over the filled inputs (its answer is the call's) and then
    captures it there. Results are bit for bit the eager chain's over the
    same bucket of queries: the same kernels run in the same order.

    An owner of int8 and f32 mirrors (the ``Gallery``, a sharded view) keeps
    one and calls ``clear`` wherever it rebuilds them. Entries are keyed on
    the card, the bucket, ``D``, ``N``, ``rescore`` and the mirrors' data
    pointers, and hold the mirrors, so that nothing a graph reads is freed
    under it; in-place patches keep the pointers, so replays see writes as
    eager calls do. A card keeps at most ``len(GRAPH_QUERIES)`` entries, the
    least recently used dropped first: one per bucket over the owner's
    mirrors, so that no traffic makes it capture again and again.

    A card's graphs over one pair of mirrors share one memory pool (its
    scratch is the largest chain's, not the sum), so one's scratch may be
    another's output: a lock per card covers filling the inputs, the replay
    and the selection, which go in that order on the calling thread's
    current stream (the card's default stream in the gallery). Graphs over
    other mirrors on the card (the shards of a mesh that lists one card
    several times) have pools of their own, so that one shard's replay
    leaves another's outputs as they were.

    ``candidates`` is the chain up to the selection, for the sharded merge:
    the caller holds the locks of its cards (``hold``) until what reads the
    static outputs it hands back has been enqueued.

    ``search.int8.graph_captures`` and ``search.int8.graph_replays`` count
    captures and replays in the tracer's counters; B2's and the candidate
    select's ``launches`` count their runs, a replay's too. On other devices
    ``topk`` and ``candidates`` run the eager chain."""

    def __init__(self):
        self._entries: dict[torch.device,
                            collections.OrderedDict[tuple, _Int8Graph]] = {}
        self._cards: dict[torch.device, _Card] = {}
        self._lock = threading.Lock()  # the dicts, the cards' pools too

    @staticmethod
    def bucket(q: int) -> int | None:
        """The captured query count that holds ``q`` queries, if any."""
        return next((b for b in GRAPH_QUERIES if b >= q), None)

    @staticmethod
    def key(bucket: int, gallery_i8: torch.Tensor,
            gallery_f32: torch.Tensor, rescore: int) -> tuple:
        n, d = gallery_f32.shape
        return (gallery_f32.device, bucket, d, n, rescore,
                gallery_i8.data_ptr(), gallery_f32.data_ptr())

    @staticmethod
    def stage(queries: np.ndarray, device: torch.device) -> torch.Tensor:
        """Host queries as an f32 tensor, pinned for a card, so that each
        copy to a card waits for nothing (the host allocator keeps the
        block until the copies have run)."""
        host = torch.from_numpy(np.array(queries, np.float32))
        return host.pin_memory() if device.type == "cuda" else host

    def __len__(self) -> int:
        with self._lock:
            return sum(map(len, self._entries.values()))

    def clear(self) -> None:
        """Drop every entry (a call in flight keeps its own)."""
        with self._lock:
            self._entries.clear()
            for card in self._cards.values():
                card.pools.clear()

    def _get(self, device, key) -> _Int8Graph | None:
        with self._lock:
            entries = self._entries.get(device)
            entry = None if entries is None else entries.get(key)
            if entry is not None:
                entries.move_to_end(key)
            return entry

    def _put(self, device, key, entry) -> None:
        """Keep ``entry``; the card's least recently used beyond
        ``len(GRAPH_QUERIES)`` go."""
        with self._lock:
            entries = self._entries.setdefault(device,
                                               collections.OrderedDict())
            entries[key] = entry
            while len(entries) > len(GRAPH_QUERIES):
                entries.popitem(last=False)

    def _card(self, device: torch.device) -> _Card:
        with self._lock:
            card = self._cards.get(device)
            if card is None:
                card = self._cards[device] = _Card(threading.Lock(), {})
            return card

    def _pool(self, card: _Card, gallery_i8: torch.Tensor,
              gallery_f32: torch.Tensor) -> tuple:
        """The memory pool of the card's graphs over these mirrors."""
        mirrors = (gallery_i8.data_ptr(), gallery_f32.data_ptr())
        with self._lock:
            pool = card.pools.get(mirrors)
            if pool is None:
                pool = card.pools[mirrors] = torch.cuda.graph_pool_handle()
            return pool

    @contextlib.contextmanager
    def hold(self, devices):
        """Hold the locks of the CUDA cards among ``devices``, each once, in
        one order for every holder."""
        cards = sorted({d for d in devices if d.type == "cuda"}, key=str)
        with contextlib.ExitStack() as held:
            for dev in cards:
                held.enter_context(self._card(dev).lock)
            yield

    def topk(
        self,
        queries,                    # [Q, D] host: an array, or ``stage``'s
        gallery_i8: torch.Tensor,   # [N, D] int8 of normalised rows
        gallery_f32: torch.Tensor,  # [N, D] normalised f32
        mask: torch.Tensor,         # [N] bool
        k: int,
        rescore: int = 256,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``int8_scan_topk`` of host ``queries`` over one card's mirrors
        → (scores [Q, k], rows [Q, k]) on the mirrors' device, the
        caller's to keep."""
        dev = gallery_f32.device
        if isinstance(queries, np.ndarray):
            queries = self.stage(queries, dev)
        bucket = self._graphed(queries, dev, rescore)
        if bucket is None:
            return int8_scan_topk(queries.to(dev), gallery_i8, gallery_f32,
                                  mask, k=k, rescore=rescore)
        q = queries.shape[0]
        with torch.cuda.device(dev), self._card(dev).lock:
            exact, rows = self._run(queries, bucket, gallery_i8, gallery_f32,
                                    mask, rescore)
            return _best(exact[:q], rows[:q], k)

    def candidates(
        self,
        queries,                    # [Q, D] host: an array, or ``stage``'s
        gallery_i8: torch.Tensor,   # [N, D] int8 of normalised rows
        gallery_f32: torch.Tensor,  # [N, D] normalised f32
        mask: torch.Tensor,         # [N] bool
        rescore: int = 256,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``topk``'s chain up to its best-k → (exact scores [Q, r] f32,
        rows [Q, r] int64) on the mirrors' device. The caller holds the
        card's lock (``hold``): a replay's are views of the graph's static
        outputs, which the card's next replay overwrites."""
        dev = gallery_f32.device
        if isinstance(queries, np.ndarray):
            queries = self.stage(queries, dev)
        bucket = self._graphed(queries, dev, rescore)
        if bucket is None:
            return _int8_candidates(queries.to(dev), gallery_i8, gallery_f32,
                                    mask, rescore)
        q = queries.shape[0]
        with torch.cuda.device(dev):
            exact, rows = self._run(queries, bucket, gallery_i8, gallery_f32,
                                    mask, rescore)
        return exact[:q], rows[:q]

    def _graphed(self, queries: torch.Tensor, dev: torch.device,
                 rescore: int) -> int | None:
        """The bucket whose graph serves the call; None for the eager
        chain (another device, no queries, more than the largest bucket,
        more candidates than ``GRAPH_MAX_RESCORE``)."""
        q = queries.shape[0]
        if dev.type != "cuda" or q == 0 or rescore > GRAPH_MAX_RESCORE:
            return None
        return self.bucket(q)

    def _run(self, queries: torch.Tensor, bucket: int,
             gallery_i8: torch.Tensor, gallery_f32: torch.Tensor,
             mask: torch.Tensor, rescore: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """Fill and replay the bucket's graph, capturing it on its first
        call, with the card current and its lock held → the rescored
        candidates [bucket, r]: the static outputs, or the first call's
        own."""
        dev = gallery_f32.device
        key = self.key(bucket, gallery_i8, gallery_f32, rescore)
        g = self._get(dev, key)
        if g is None:
            pool = self._pool(self._card(dev), gallery_i8, gallery_f32)
            g, exact, rows = self._capture(queries, bucket, gallery_i8,
                                           gallery_f32, mask, rescore, pool)
            self._put(dev, key, g)
            return exact, rows
        g.queries[:queries.shape[0]].copy_(queries, non_blocking=True)
        g.mask.copy_(mask)
        g.graph.replay()
        for lib, recorded in g.recorded.items():
            lib.replayed(recorded)
        tracer.count("search.int8.graph_replays")
        return g.exact, g.rows

    @staticmethod
    def _capture(queries: torch.Tensor, bucket: int,
                 gallery_i8: torch.Tensor, gallery_f32: torch.Tensor,
                 mask: torch.Tensor, rescore: int, pool: tuple):
        """The first call of a bucket on the current card: fill new static
        inputs, run the chain over them on a side stream (the kernels' lazy
        set-up happens outside the capture, and its answer is this call's),
        then capture it on that stream → (entry, exact, rows)."""
        dev = gallery_f32.device
        static_q = torch.zeros((bucket, queries.shape[1]),
                               dtype=torch.float32, device=dev)
        static_q[:queries.shape[0]].copy_(queries, non_blocking=True)
        static_mask = mask.clone()
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            with torch.cuda.stream(side):
                exact, rows = _int8_candidates(static_q, gallery_i8,
                                               gallery_f32, static_mask,
                                               rescore)
            before = {lib: dict(lib.recorded) for lib in (B2, SELECT)}
            # thread_local: other threads go on launching on their streams.
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = _int8_candidates(static_q, gallery_i8, gallery_f32,
                                       static_mask, rescore)
            recorded = {lib: {fn: n - was[fn]
                              for fn, n in lib.recorded.items()}
                        for lib, was in before.items()}
        current.wait_stream(side)
        for t in (exact, rows):
            t.record_stream(current)
        tracer.count("search.int8.graph_captures")
        return (_Int8Graph(graph, static_q, static_mask, *out, recorded,
                           (gallery_i8, gallery_f32)), exact, rows)


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
    return _rescore(qn, gallery_f32, cand_i, k, cand_s > sentinel)


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
    return _rescore(qn, gallery_f32, cand_i, k, cand_s > NEG_INF / 2)


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
    return _rescore(qn, gallery_f32, cand_i, k, cand_s > NEG_INF / 2)
