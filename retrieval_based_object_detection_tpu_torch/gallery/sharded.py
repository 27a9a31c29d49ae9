"""Sharded gallery search: a collection's rows split over a mesh's devices.

Each device along the mesh's ``gallery`` axis holds one contiguous shard of
rows. A search scores the queries against every shard on that shard's
device with the single-device search functions (``search.masked_cosine_topk``,
``int8_scan_topk`` — kernel B2 on CUDA — or ``int4_scan_topk`` — kernel B3),
takes a LOCAL top-k there, and copies each shard's [Q, k] candidates to the
first shard's device for one merge: the [Q, N] score matrix never leaves its
shard, so the traffic is O(shards × k) per query batch. The int8 tier hands
over each shard's rescored [Q, r] candidates instead, and one launch of
kernel P2 on the first card (``ops/shard_merge.py``) takes the best k of
their union, reading them where they lie.

The port of the JAX package's ``gallery/sharded.py``. Its single-controller
``shard_map`` becomes a loop over the shards, one scan per shard per
search, each on its shard's device and that device's current stream (the
int8 tier's whole chain as one replay of a CUDA graph on each card); its
``all_gather`` becomes the copy to the first shard, or P2's reads. Exactness:
cosine top-k over the union of shards equals single-device top-k, with ties
broken by shard order as ``lax.top_k`` breaks them (a stable sort).
"""

from __future__ import annotations

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.gallery import search as search_lib
from retrieval_based_object_detection_tpu_torch.gallery.capacity import (
    _CHUNK,
    _WritableView,
    _build_planes,
)
from retrieval_based_object_detection_tpu_torch.gallery.search import upload
from retrieval_based_object_detection_tpu_torch.ops.shard_merge import (
    Merged,
    shard_merge,
    shard_merge_plain,
)
from retrieval_based_object_detection_tpu_torch.utils import (
    logging as tracer,
)

AXIS = "gallery"

# Rows per write tile: a shard's row count is a multiple of it, so a tile
# never spans two shards.
_WRITE_TILE = 256
# Past this many rows a shard pads to a multiple of the JAX scan kernel's
# row tile (its ``TILE_ROWS``), as the JAX view does; 256 below it.
_SCAN_SHARD_ROWS = 131_072
_SCAN_TILE_ROWS = 8192


def shard_rows(n_rows: int, n_shards: int) -> int:
    """Padded per-shard row count: a multiple of 256 when small, of 8,192
    once a shard reaches 131,072 rows (the JAX view's rule; padded rows are
    masked off)."""
    per = -(-n_rows // n_shards)
    multiple = _SCAN_TILE_ROWS if per >= _SCAN_SHARD_ROWS else 256
    return search_lib.pad_rows(per, multiple)


def shard_devices(mesh) -> list[torch.device]:
    """One device per shard: the mesh's devices along its gallery axis."""
    if AXIS not in mesh.shape:
        raise ValueError(f"mesh has no '{AXIS}' axis: {dict(mesh.shape)}")
    return mesh.axis_devices(AXIS)


def build_sharded(
    vectors: np.ndarray,  # [N, D] float32
    mask: np.ndarray,     # [N] bool
    mesh,
    headroom: int = 0,
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """L2-normalise, pad and place gallery rows over the mesh's gallery
    axis: (per-shard rows [R, D] f32, per-shard masks [R] bool), shard s
    holding global rows [s·R, (s+1)·R). ``headroom`` extra rows reserve
    append capacity for the write path (zero and masked until written)."""
    devices = shard_devices(mesh)
    n, d = vectors.shape
    per = shard_rows(n + max(0, headroom), len(devices))
    rows_out, masks_out = [], []
    for s, dev in enumerate(devices):
        lo, hi = s * per, min((s + 1) * per, n)
        buf = np.zeros((per, d), np.float32)
        mbuf = np.zeros(per, bool)
        if hi > lo:
            v = vectors[lo:hi]
            norms = np.linalg.norm(v, axis=1, keepdims=True)
            buf[: hi - lo] = v / np.maximum(norms, 1e-12)
        mhi = min((s + 1) * per, mask.shape[0])
        if mhi > lo:
            mbuf[: mhi - lo] = mask[lo:mhi]
        rows_out.append(upload(buf, dev))
        masks_out.append(upload(mbuf, dev))
    return rows_out, masks_out


def _gather_merge(scores: list[torch.Tensor], idx: list[torch.Tensor],
                  rows_per: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The shard merge of the exact, bf16 and int4 tiers: each shard's
    [Q, k] candidates (rows of any integer type) merged by P2's plain
    version on the first shard's device."""
    return shard_merge_plain(scores, [i.to(torch.int64) for i in idx],
                             rows_per, k)


def _per_shard(queries: torch.Tensor, shards: list[tuple], fn
               ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Run ``fn(q, *shard_tensors)`` on each shard's device (a kernel
    launches on its tensors' card): its (scores, rows) lists, in shard
    order."""
    scores, idx = [], []
    for tensors in shards:
        s, i = fn(queries.to(tensors[0].device), *tensors)
        scores.append(s)
        idx.append(i)
    return scores, idx


def sharded_topk(
    queries: torch.Tensor,        # [Q, D]
    gallery: list[torch.Tensor],  # per shard [R, D], normalised rows
    mask: list[torch.Tensor],     # per shard [R] bool
    mesh,
    k: int,
    exact: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked cosine top-k over the shards → (scores [Q, k], global row
    indices [Q, k]) on the first shard's device."""
    _check_shards(mesh, gallery)
    scores, idx = _per_shard(
        queries, list(zip(gallery, mask)),
        lambda q, g, m: search_lib.masked_cosine_topk(
            q, g, m, k=k, exact=exact, gallery_normalized=True))
    return _gather_merge(scores, idx, gallery[0].shape[0], k)


def sharded_int8_topk(
    queries: np.ndarray,              # [Q, D] unnormalised, host
    gallery_i8: list[torch.Tensor],   # per shard [R, D] int8
    gallery_f32: list[torch.Tensor],  # per shard [R, D] rows to rescore
    mask: list[torch.Tensor],         # per shard [R] bool
    mesh,
    k: int,
    rescore: int = 256,
    *,
    graphs: search_lib.Int8ScanGraphs,
) -> Merged:
    """The int8 scan (kernel B2 on CUDA) and exact f32 rescore on each
    shard, then the best k of the union of the shards' rescored candidates
    (kernel P2 on the first card, ``ops/shard_merge.py``; its plain version
    on the CPU). On CUDA each shard's chain is one replay of its graph in
    ``graphs``; all are launched before the merge, so the cards work at
    once, and the cards' locks are held until the merge is launched, so
    that no other call's replay overwrites candidates it has yet to read.
    ``search.sharded.merges`` counts the calls that launch P2."""
    _check_shards(mesh, gallery_f32)
    host = graphs.stage(queries, gallery_f32[0].device)  # pinned once
    with graphs.hold([g.device for g in gallery_f32]):
        cands = [graphs.candidates(host, gi, gf, m, rescore=rescore)
                 for gi, gf, m in zip(gallery_i8, gallery_f32, mask)]
        out = shard_merge([c[0] for c in cands], [c[1] for c in cands],
                          gallery_f32[0].shape[0], k)
    if out.buf is not None:
        tracer.count("search.sharded.merges")
    return out


def sharded_int4_topk(
    queries: torch.Tensor,            # [Q, D] unnormalised f32
    packed: list[torch.Tensor],       # per shard [R, D/2] int8
    scales: list[torch.Tensor],       # per shard [R] f32
    gallery_f32: list[torch.Tensor],  # per shard [R, D] rows to rescore
    mask: list[torch.Tensor],         # per shard [R] bool
    mesh,
    k: int,
    rescore: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int4 scan (kernel B3 on CUDA, one launch per shard) and rescore
    on each shard, then the merge: the int8 tier's sibling at half its
    bytes."""
    _check_shards(mesh, gallery_f32)
    scores, idx = _per_shard(
        queries, list(zip(packed, scales, gallery_f32, mask)),
        lambda q, p, s, gf, m: search_lib.int4_scan_topk(
            q, p, s, gf, m, k=k, rescore=rescore))
    return _gather_merge(scores, idx, gallery_f32[0].shape[0], k)


def _check_shards(mesh, shards: list[torch.Tensor]) -> None:
    devices = shard_devices(mesh)
    if len(shards) != len(devices) or any(
            t.device != d for t, d in zip(shards, devices)):
        raise ValueError(f"{len(shards)} shards on "
                         f"{[str(t.device) for t in shards]} do not match "
                         f"the mesh's gallery devices {devices}")


class ShardedGallerySearcher(_WritableView):
    """Writable search view over a Gallery's rows, sharded over a mesh.

    ``dev_vectors`` / ``dev_mask`` are lists with one tensor per shard
    (``rows_per`` rows each, ``total`` in all). Filters apply through the
    build-time mask, or at query time through ``extra_mask``: a host bool
    array over the rows, or per-shard device masks (``split_mask``)."""

    def __init__(self, vectors: np.ndarray, mask: np.ndarray, mesh,
                 capacity: bool = False,
                 ids: list[str] | None = None,
                 headroom: int = 0):
        self.mesh = mesh
        self.devices = shard_devices(mesh)
        self.n_rows = vectors.shape[0]
        self.capacity = capacity
        self.ids = ids  # optional row -> point-id mapping (from_gallery)
        n_shards = len(self.devices)
        self.rows_per = shard_rows(self.n_rows + max(0, headroom), n_shards)
        self.total = self.rows_per * n_shards
        self._dev_int8: list[torch.Tensor] | None = None  # int8 scan mirror
        # The int8 tier's chain as CUDA graphs, a few buckets per card.
        self._int8_graphs = search_lib.Int8ScanGraphs()
        # int4 tier: per shard (packed [R, D/2] int8, scales [R] f32)
        self._dev_int4: list[tuple[torch.Tensor, torch.Tensor]] | None = None
        if capacity:
            # Capacity mode (the single-device CapacitySearcher's sharded
            # sibling): a bf16 rescore mirror and int4 planes only, ~2.5
            # bytes/dim per shard, built chunk by chunk from the host rows
            # (one staged f32 chunk on the device at a time). Quantised
            # tiers only; rescored hit scores carry bf16's error.
            per = self.rows_per
            chunk = max(256, (min(_CHUNK, per) // 256) * 256)
            self.dev_vectors, self._dev_int4 = [], []
            for s, dev in enumerate(self.devices):
                bf16, packed, scales = _build_planes(vectors, s * per, per,
                                                     chunk, dev)
                self.dev_vectors.append(bf16)
                self._dev_int4.append((packed, scales))
        # Host shadow of the row mask (total bools): the write path pushes
        # only the tiles it touched from it — whole-tile constants would
        # revive tombstones or mark padded rows live on edge tiles.
        self._host_mask = np.zeros(self.total, bool)
        self._host_mask[: mask.shape[0]] = mask
        if capacity:
            self.dev_mask = self.split_mask(self._host_mask)
        else:
            self.dev_vectors, self.dev_mask = build_sharded(
                vectors, mask, mesh, headroom=headroom)

    def split_mask(self, host_mask: np.ndarray) -> list[torch.Tensor]:
        """A host bool array over the rows (shorter ones pad with False)
        as per-shard device masks."""
        m = np.asarray(host_mask, bool)
        out = []
        for s, dev in enumerate(self.devices):
            buf = np.zeros(self.rows_per, bool)
            lo = s * self.rows_per
            hi = min(lo + self.rows_per, m.shape[0])
            if hi > lo:
                buf[: hi - lo] = m[lo:hi]
            out.append(upload(buf, dev))
        return out

    def ensure_mirror(self, method: str) -> None:
        """Build the lazy mirror that tier ``method`` scans, if it is
        missing, on each shard's device from its normalised rows: the int8
        rows for "int8" (quantised with the query side's quantiser — the
        exact-integer scores depend on the two matching bit for bit; in
        capacity mode the source rows are bf16, so the int8 tier is then
        approximate at bf16 fidelity), the int4 planes for "int4"."""
        if method == "int8" and self._dev_int8 is None:
            self._int8_graphs.clear()
            self._dev_int8 = [search_lib.quantize_rows_int8(v)
                              for v in self.dev_vectors]
        elif method == "int4" and self._dev_int4 is None:
            self._dev_int4 = [search_lib.pack_rows_int4(v)
                              for v in self.dev_vectors]

    @classmethod
    def from_gallery(cls, gallery, mesh, flt=None,
                     capacity: bool = False, headroom: int = 0
                     ) -> "ShardedGallerySearcher":
        gallery.compact()  # dense live-row view (no-op if no tombstones)
        n = len(gallery)
        vectors = gallery._vectors[:n]
        mask = gallery._payloads.mask(flt)
        return cls(vectors, mask, mesh, capacity=capacity,
                   ids=list(gallery._ids), headroom=headroom)

    # ------------------------------------------------------------ writes
    # Incremental writes, as the capacity view patches them. Every built
    # mirror (rows, int8, int4 planes) and the mask patch in lockstep, so a
    # small upsert never rebuilds the view.
    _tile = _WRITE_TILE

    def _locate(self, ts: int) -> tuple[torch.Tensor, torch.Tensor, int]:
        s, lo = divmod(ts, self.rows_per)
        return self.dev_mask[s], self.dev_vectors[s], lo

    _upload_mask = split_mask

    def upsert_rows(self, start: int, vectors: np.ndarray,
                    valid: bool = True) -> None:
        """Overwrite/append rows [start, start+m); appends must stay
        within the build-time padded row count (shards × per-shard)."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        m = vectors.shape[0]
        if start < 0 or start > self.n_rows:
            raise ValueError(
                f"start {start} outside [0, {self.n_rows}] — sharded "
                "writes are overwrites or contiguous appends")
        if start + m > self.total:
            raise ValueError(
                f"write to row {start + m} exceeds padded capacity "
                f"{self.total}; rebuild the view over a bigger mesh/row "
                "count")
        rows = vectors / np.maximum(
            np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12)
        self._patch_rows(start, rows, valid)

    def _write_tile(self, staged: np.ndarray, ts: int) -> None:
        s, lo = divmod(ts, self.rows_per)
        hi = lo + staged.shape[0]
        rows = upload(staged, self.devices[s])
        self.dev_vectors[s][lo:hi] = rows.to(self.dev_vectors[s].dtype)
        if self._dev_int8 is not None:
            self._dev_int8[s][lo:hi] = search_lib.quantize_rows_int8(rows)
        if self._dev_int4 is not None:
            packed, scales = self._dev_int4[s]
            packed[lo:hi], scales[lo:hi] = search_lib.pack_rows_int4(rows)

    # ``set_rows_invalid`` under the JAX package's name for it.
    delete_rows = _WritableView.set_rows_invalid

    def search(self, queries: np.ndarray, k: int = 10, exact: bool = True,
               method: str | None = None,
               extra_mask=None,
               ) -> tuple[np.ndarray, np.ndarray]:
        """``method``: "exact"/"bf16" (the matmul tiers), "int8" or "int4"
        (the scan kernels and an exact f32 rescore per shard); defaults
        from ``exact`` as Gallery.search does. ``extra_mask`` (a host bool
        array over the rows, or per-shard device masks) is ANDed with the
        view's mask. Returns host (scores [Q, k], global rows [Q, k])."""
        if method is None:
            method = ("int4" if self.capacity
                      else "exact" if exact else "bf16")
        if self.capacity and method == "exact":
            raise ValueError(
                "capacity mode keeps only a bf16 rescore mirror — "
                "method='exact' (f32) is unavailable; use "
                "'int4'/'int8'/'bf16' or build without capacity=True")
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        mask = self.dev_mask
        if extra_mask is not None:
            if not isinstance(extra_mask, (list, tuple)):
                extra_mask = self.split_mask(
                    np.asarray(extra_mask, bool)[: self.n_rows])
            mask = [a & b.to(a.device) for a, b in zip(mask, extra_mask)]
        # Each shard takes its own top-k, so k must fit one shard.
        per_shard = self.rows_per
        k_eff = min(k, self.n_rows, per_shard)
        rescore = search_lib.rescore_depth(k_eff, per_shard)
        self.ensure_mirror(method)
        if method == "int8":
            # The host queries go straight into each card's graph input;
            # the merge's answer comes back in one copy.
            return sharded_int8_topk(
                queries, self._dev_int8, self.dev_vectors, mask, self.mesh,
                k=k_eff, rescore=rescore, graphs=self._int8_graphs).host()
        q = upload(queries, self.devices[0])
        if method == "int4":
            scores, idx = sharded_int4_topk(
                q, [p for p, _ in self._dev_int4],
                [s for _, s in self._dev_int4], self.dev_vectors, mask,
                self.mesh, k=k_eff, rescore=rescore)
        else:
            scores, idx = sharded_topk(
                q, self.dev_vectors, mask, self.mesh, k=k_eff,
                exact=(method == "exact"))
        return scores.cpu().numpy(), idx.cpu().numpy()
