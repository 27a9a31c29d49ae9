"""Sharded gallery search: a collection's rows split over a mesh's devices.

Each device along the mesh's ``gallery`` axis holds one contiguous shard of
rows. A search scores the queries against every shard on that shard's
device with the single-device search functions (``search.masked_cosine_topk``,
``int8_scan_topk`` — kernel B2 on CUDA — or ``int4_scan_topk`` — kernel B3),
takes a LOCAL top-k there, and copies each shard's [Q, k] candidates to the
first shard's device for one merge: the [Q, N] score matrix never leaves its
shard, so the traffic is O(shards × k) per query batch.

The port of the JAX package's ``gallery/sharded.py``. Its single-controller
``shard_map`` becomes a loop over the shards, one launch of the scan kernel
per shard per search, each on its shard's device and that device's current
stream; its ``all_gather`` becomes the copy to the first shard. Exactness:
cosine top-k over the union of shards equals single-device top-k, with ties
broken by shard order as ``lax.top_k`` breaks them (a stable sort).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.gallery import search as search_lib
from retrieval_based_object_detection_tpu_torch.gallery.capacity import (
    _CHUNK,
    fill_planes,
    id_keyed_upsert,
)
from retrieval_based_object_detection_tpu_torch.gallery.store import upload

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


def _on(device: torch.device):
    """Make ``device`` current, so a kernel launches on it and its stream."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


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
    """The one shard merge of every tier: globalise each shard's [Q, k]
    candidate rows, bring them to the first shard's device in shard order,
    and keep the best k. A stable sort keeps the earlier candidate among
    equal scores (ties broken by shard order, as JAX's ``lax.top_k`` over
    the gathered candidates breaks them); ``torch.topk`` promises no
    order."""
    dev = scores[0].device
    flat_s = torch.cat([s.to(dev) for s in scores], dim=1)  # [Q, S·k]
    flat_i = torch.cat([(i.to(torch.int64) + sid * rows_per).to(dev)
                        for sid, i in enumerate(idx)], dim=1)
    order = torch.sort(flat_s, dim=1, descending=True, stable=True
                       ).indices[:, :k]
    return torch.gather(flat_s, 1, order), torch.gather(flat_i, 1, order)


def _per_shard(queries: torch.Tensor, shards: list[tuple], fn
               ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Run ``fn(q, *shard_tensors)`` on each shard's device, with the
    shard's device current: its (scores, rows) lists, in shard order."""
    scores, idx = [], []
    for tensors in shards:
        dev = tensors[0].device
        with _on(dev):
            s, i = fn(queries.to(dev), *tensors)
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
    queries: torch.Tensor,            # [Q, D] unnormalised f32
    gallery_i8: list[torch.Tensor],   # per shard [R, D] int8
    gallery_f32: list[torch.Tensor],  # per shard [R, D] rows to rescore
    mask: list[torch.Tensor],         # per shard [R] bool
    mesh,
    k: int,
    rescore: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 scan (kernel B2 on CUDA, one launch per shard) and exact
    f32 rescore on each shard, then the merge."""
    _check_shards(mesh, gallery_f32)
    scores, idx = _per_shard(
        queries, list(zip(gallery_i8, gallery_f32, mask)),
        lambda q, gi, gf, m: search_lib.int8_scan_topk(
            q, gi, gf, m, k=k, rescore=rescore))
    return _gather_merge(scores, idx, gallery_f32[0].shape[0], k)


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


class ShardedGallerySearcher:
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
        self._id_to_row: dict[str, int] | None = None
        n_shards = len(self.devices)
        self.rows_per = shard_rows(self.n_rows + max(0, headroom), n_shards)
        self.total = self.rows_per * n_shards
        self._dev_int8: list[torch.Tensor] | None = None  # int8 scan mirror
        # int4 tier: per shard (packed [R, D/2] int8, scales [R] f32)
        self._dev_int4: list[tuple[torch.Tensor, torch.Tensor]] | None = None
        if capacity:
            # Capacity mode (the single-device CapacitySearcher's sharded
            # sibling): a bf16 rescore mirror and int4 planes only, ~2.5
            # bytes/dim per shard, built chunk by chunk from the host rows
            # (one staged f32 chunk on the device at a time). Quantised
            # tiers only; rescored hit scores carry bf16's error.
            d = vectors.shape[1]
            per = self.rows_per
            chunk = max(256, (min(_CHUNK, per) // 256) * 256)
            self.dev_vectors, self._dev_int4 = [], []
            for s, dev in enumerate(self.devices):
                bf16 = torch.zeros((per, d), dtype=torch.bfloat16,
                                   device=dev)
                packed = torch.zeros((per, d // 2), dtype=torch.int8,
                                     device=dev)
                scales = torch.zeros(per, dtype=torch.float32, device=dev)
                for start in range(0, per, chunk):
                    c = min(chunk, per - start)
                    buf = np.zeros((c, d), np.float32)
                    lo = s * per + start
                    hi = min(lo + c, self.n_rows)
                    if hi > lo:
                        buf[: hi - lo] = vectors[lo:hi]
                    fill_planes(bf16, packed, scales, upload(buf, dev),
                                start)
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

    def _build_int8(self) -> None:
        """Per-shard int8 mirror (lazy), quantised on each shard's device
        from its normalised rows with the query side's quantiser — the
        exact-integer scores depend on the two matching bit for bit. In
        capacity mode the source rows are bf16, so the int8 tier is then
        approximate at bf16 fidelity."""
        self._dev_int8 = [search_lib.quantize_rows_int8(v)
                          for v in self.dev_vectors]

    def _build_int4(self) -> None:
        """Per-shard int4 planes (lazy), packed on each shard's device."""
        self._dev_int4 = [search_lib.pack_rows_int4(v)
                          for v in self.dev_vectors]

    def ensure_mirror(self, method: str) -> None:
        """Build the lazy mirror that tier ``method`` scans, if it is
        missing: the int8 rows for "int8", the int4 planes for "int4"."""
        if method == "int8" and self._dev_int8 is None:
            self._build_int8()
        elif method == "int4" and self._dev_int4 is None:
            self._build_int4()

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

    def ids_of(self, idx: np.ndarray) -> list:
        """Translate ``search`` row indices to point ids (views built
        by ``from_gallery`` or with ``ids=``); rows past the id list map to
        None."""
        if self.ids is None:
            raise ValueError("this view was built from raw vectors — "
                             "construct with ids= or from_gallery for "
                             "id translation")
        return [[self.ids[int(i)] if 0 <= int(i) < len(self.ids)
                 else None for i in row]
                for row in np.atleast_2d(idx)]

    # ------------------------------------------------------------ writes
    # Incremental writes, as the capacity view patches them: full tiles
    # from the new rows, partial edge tiles read back, overlaid and
    # re-pushed. Every built mirror (rows, int8, int4 planes) and the mask
    # patch in lockstep, so a small upsert never rebuilds the view.
    _TILE = _WRITE_TILE

    def capacity_left(self) -> int:
        return self.total - self.n_rows

    def _locate(self, row: int) -> tuple[int, int]:
        return divmod(row, self.rows_per)

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
        end = start + m
        if end > self.total:
            raise ValueError(
                f"write to row {end} exceeds padded capacity {self.total}; "
                "rebuild the view over a bigger mesh/row count")
        rows = vectors / np.maximum(
            np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12)
        tile = self._TILE
        for ts in range((start // tile) * tile, end, tile):
            te = ts + tile
            if ts >= start and te <= end:
                staged = rows[ts - start: te - start]
            else:
                s, lo = self._locate(ts)
                staged = self.dev_vectors[s][lo: lo + tile].to(
                    torch.float32).cpu().numpy()
                lo, hi = max(start, ts), min(end, te)
                staged[lo - ts: hi - ts] = rows[lo - start: hi - start]
            self._patch_write_tile(staged, ts)
        self.n_rows = max(self.n_rows, end)
        self._set_mask_range(start, end, valid)

    def _patch_write_tile(self, staged: np.ndarray, ts: int) -> None:
        s, lo = self._locate(ts)
        hi = lo + staged.shape[0]
        rows = upload(staged, self.devices[s])  # a copy: staged may alias
        self.dev_vectors[s][lo:hi] = rows.to(self.dev_vectors[s].dtype)
        if self._dev_int8 is not None:
            self._dev_int8[s][lo:hi] = search_lib.quantize_rows_int8(rows)
        if self._dev_int4 is not None:
            packed, scales = self._dev_int4[s]
            packed[lo:hi], scales[lo:hi] = search_lib.pack_rows_int4(rows)

    def _push_mask_tile(self, ts: int) -> None:
        s, lo = self._locate(ts)
        self.dev_mask[s][lo: lo + self._TILE] = upload(
            self._host_mask[ts: ts + self._TILE], self.devices[s])

    def _set_mask_range(self, lo: int, hi: int, value: bool) -> None:
        """Update [lo, hi) in the host shadow and push ONLY the touched
        tiles."""
        self._host_mask[lo:hi] = value
        tile = self._TILE
        for ts in range((lo // tile) * tile, hi, tile):
            self._push_mask_tile(ts)

    def _ensure_id_map(self) -> dict[str, int]:
        if self.ids is None:
            raise ValueError("id-keyed writes need a view built with "
                             "ids= (or from_gallery)")
        if self._id_to_row is None or len(self._id_to_row) != len(self.ids):
            self._id_to_row = {pid: i for i, pid in enumerate(self.ids)}
        return self._id_to_row

    def upsert(self, ids, vectors: np.ndarray) -> int:
        """Id-keyed insert-or-replace (Gallery.upsert semantics; the one
        implementation shared with ``CapacitySearcher.upsert``)."""
        return id_keyed_upsert(self, ids, vectors, self.total)

    def delete(self, ids) -> int:
        """Tombstone rows by id through the mask."""
        id_map = self._ensure_id_map()
        return self.delete_rows(
            [id_map[pid] for pid in ids if pid in id_map])

    def delete_rows(self, rows: "np.ndarray | list[int]") -> int:
        """Tombstone rows through the mask (the rows stay put); each
        touched mask tile is pushed once for the whole batch."""
        live = [int(r) for r in np.atleast_1d(np.asarray(rows))
                if 0 <= int(r) < self.n_rows and self._host_mask[int(r)]]
        for r in live:
            self._host_mask[r] = False
        tile = self._TILE
        for ts in sorted({(r // tile) * tile for r in live}):
            self._push_mask_tile(ts)
        return len(live)

    # Name parity with CapacitySearcher, so the Gallery's pending-op replay
    # drives both view kinds through one code path.
    set_rows_invalid = delete_rows

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
                m = np.asarray(extra_mask, bool)[: self.n_rows]
                extra_mask = self.split_mask(m)
            mask = [a & b.to(a.device) for a, b in zip(mask, extra_mask)]
        # Each shard takes its own top-k, so k must fit one shard.
        per_shard = self.rows_per
        k_eff = min(k, self.n_rows, per_shard)
        q = upload(queries, self.devices[0])
        rescore = min(max(8 * k_eff, 256), per_shard)
        self.ensure_mirror(method)
        if method == "int8":
            scores, idx = sharded_int8_topk(
                q, self._dev_int8, self.dev_vectors, mask, self.mesh,
                k=k_eff, rescore=rescore)
        elif method == "int4":
            scores, idx = sharded_int4_topk(
                q, [p for p, _ in self._dev_int4],
                [s for _, s in self._dev_int4], self.dev_vectors, mask,
                self.mesh, k=k_eff, rescore=rescore)
        else:
            scores, idx = sharded_topk(
                q, self.dev_vectors, mask, self.mesh, k=k_eff,
                exact=(method == "exact"))
        return scores.cpu().numpy(), idx.cpu().numpy()
