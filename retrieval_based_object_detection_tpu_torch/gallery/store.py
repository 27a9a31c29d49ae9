"""In-process vector gallery with Qdrant-equivalent semantics.

Payloads live host-side in columnar NumPy (``schema.PayloadColumns``),
vectors in a host float32 buffer (optionally a disk-backed memmap,
``vectors_path``) mirrored lazily onto the device as padded tensors,
L2-normalised for cosine collections. Filters lower to a boolean row mask;
the device does one masked matmul (or a quantised scan) plus top-k.

The port of the JAX package's ``gallery/store.py`` for one device:
``upsert``, tombstone ``delete`` with lazy ``compact`` / ``maintain``,
``count``, ``scroll``/``scroll_all``, ``distinct``, ``vectors_matching``,
``retrieve``, ``get_by_path`` (with the resolved-path fallback), lazily
materialised ids after a binary snapshot load (``gallery.persist``),
incrementally patched f32/bf16/int8/int4 device mirrors, the writable
capacity view (``gallery.capacity``), the writable sharded view over a
device mesh (``gallery.sharded``, ``attach_mesh``), and ``search`` over
exact / bf16 / int8 / int4 / capacity / sharded under the same
auto-routing, for all four metrics.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.gallery import planes, sharded
from retrieval_based_object_detection_tpu_torch.gallery import search as search_lib
from retrieval_based_object_detection_tpu_torch.gallery.capacity import (
    CapacitySearcher,
)
from retrieval_based_object_detection_tpu_torch.gallery.schema import (
    Filter,
    Payload,
    PayloadColumns,
    _gc_paused,
)
from retrieval_based_object_detection_tpu_torch.gallery.search import upload
from retrieval_based_object_detection_tpu_torch.utils import (
    logging as tracer,
)
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


class _MaskCache(dict):
    """Device row masks by canonical filter key, each stored beside the row
    count it was built for; at most ``bound`` of them (past it the cache
    starts over). A hit is one dict read; a miss builds under ``lock``,
    once per filter across concurrent readers."""

    def __init__(self, lock, bound: int):
        super().__init__()
        self._lock = lock
        self._bound = bound

    def fetch(self, key, rows: int, build):
        """The mask of ``key`` at ``rows`` rows, built by ``build()`` when
        missing or built for another row count."""
        hit = self.get(key)
        if hit is None or hit[0] != rows:
            with self._lock:
                hit = self.get(key)
                if hit is None or hit[0] != rows:
                    mask = build()
                    if len(self) >= self._bound:
                        self.clear()
                    hit = self[key] = (rows, mask)
        return hit[1]


class _ViewHolder:
    """One writable serving view's life beside the Gallery's rows (the
    capacity view, or the sharded one): the view, None until a search
    needs it; the log of the writes made since its last sync; and its
    per-filter device masks."""

    def __init__(self, lock, mask_bound: int):
        self.view = None
        self.pending: list[tuple] = []
        self.masks = _MaskCache(lock, mask_bound)

    def drop(self) -> None:
        self.view = None
        self.pending.clear()
        self.masks.clear()

    def note(self, op) -> None:
        """A write to the Gallery: the cached masks go, and a live view
        queues ``op`` (None: nothing to queue)."""
        self.masks.clear()
        if op is not None and self.view is not None:
            self.pending.append(op)

    def sync(self, build, vectors: np.ndarray):
        """The view, built by ``build()`` when there is none, else patched
        by replaying the log IN ORDER: ``("rows", sorted_rows)`` writes
        each contiguous run of ``vectors`` as one incremental patch,
        ``("mask", rows)`` tombstones. A replay that outgrows the view's
        build-time headroom (ValueError) rebuilds it once. Called under
        the Gallery's lock: two concurrent first searches must not both
        replay (and clear) the same log."""
        if self.view is not None:
            try:
                for kind, rows in self.pending:
                    if kind == "mask":
                        self.view.set_rows_invalid(rows)
                        continue
                    run_start = 0
                    for i in range(1, len(rows) + 1):
                        if i == len(rows) or rows[i] != rows[i - 1] + 1:
                            lo, hi = int(rows[run_start]), int(rows[i - 1]) + 1
                            self.view.upsert_rows(lo, vectors[lo:hi])
                            run_start = i
            except ValueError:
                self.view = None
        if self.view is None:
            self.view = build()
            self.masks.clear()
        self.pending.clear()
        return self.view

    def mask(self, view, flt: Filter | None, payloads: PayloadColumns):
        """``flt``'s payload rows in ``view``'s device layout, cached (re-
        uploading N bools a query would dominate at 10M rows); None
        without a filter. Validity and tombstones live in the view's own
        mask."""
        if flt is None:
            return None
        return self.masks.fetch(
            flt.cache_key(), len(view._host_mask),
            lambda: view._upload_mask(payloads.mask(flt)))


@dataclass
class Record:
    """One gallery point, as returned by scroll/retrieve/search."""

    id: str
    payload: Payload
    vector: np.ndarray | None = None
    score: float | None = None


class Gallery:
    """A single named collection of (id, vector, payload) points, searched
    on ``device`` (default CUDA; a missing GPU raises)."""

    # Above this row count a serving (exact=False) search auto-routes to
    # the int8 scan when the store lives on CUDA — below it the bf16
    # matmul wins on dispatch overhead.
    INT8_SCAN_MIN_ROWS = 131_072

    # Budget of the standard serving mirrors (f32 + int8, ~5 bytes/dim) on
    # one 80 GB H100; past it an inexact search auto-routes to the capacity
    # tier (bf16 rescore mirror + int4 planes, ~2.5 bytes/dim). Of the
    # card's 80 GB (74.5 GiB), 48 GiB go to the mirrors; the rest holds
    # what a search allocates beside them at that size (the [16, N] f32
    # scores of a query batch and their top-k workspace, ~0.2 KB a row:
    # 4 GiB at the 20M rows of 512-d that 48 GiB hold), the capacity view's
    # packed rows while it is built (0.5 bytes/dim: 5 GiB), the models and
    # the allocator's slack.
    CAPACITY_AUTO_BYTES = 48 << 30

    _SYNC_CHUNK = 4096  # rows per incremental device update

    # Lazy compaction fires once tombstones pass this fraction of the
    # physical rows (and a floor, so small galleries never bother).
    _COMPACT_DEAD_FRACTION = 0.25
    _COMPACT_DEAD_MIN = 1024
    # Compaction drops every device mirror and the capacity view. Past
    # this physical row count (or whenever the capacity view is live) a
    # threshold-crossing delete DEFERS compaction to an explicit
    # ``maintain()`` call instead of compacting inline.
    _COMPACT_INLINE_MAX_ROWS = 1 << 20

    def __init__(self, name: str, dim: int = 512, capacity: int = 1024,
                 distance: str = "cosine",
                 vectors_path: str | None = None,
                 device: str | torch.device = "cuda"):
        # The four metrics the reference's collection manager offers
        # (qdrant_manager.py:61-65).
        if distance not in ("cosine", "dot", "euclid", "manhattan"):
            raise ValueError(f"unsupported distance: {distance}")
        self.name = name
        self.dim = dim
        self.distance = distance
        self.device = resolve_device(device)
        self._capacity = capacity
        # ``vectors_path`` makes the host vector buffer a disk-backed
        # np.memmap instead of RAM (10M x 512 is 20 GB of f32). Growth
        # resizes the backing file (truncate + remap, no copy).
        self._vectors_path = vectors_path
        if vectors_path:
            if os.path.exists(vectors_path) and \
                    os.path.getsize(vectors_path) > 0:
                # A fresh Gallery is an EMPTY collection: zero-truncating
                # existing rows here would lose them. Snapshots load
                # through gallery.persist, which adopts the vector block.
                raise FileExistsError(
                    f"vectors_path {vectors_path!r} already exists and "
                    "is non-empty; constructing a Gallery would "
                    "truncate it. Load snapshots via gallery.persist, "
                    "or remove the file to start an empty collection.")
            self._vectors = np.memmap(vectors_path, dtype=np.float32,
                                      mode="w+", shape=(capacity, dim))
        else:
            self._vectors = np.zeros((capacity, dim), dtype=np.float32)
        self._payloads = PayloadColumns(capacity)
        # Point ids + id→row map, LAZY after binary snapshot loads: the
        # loader parks the raw fixed-width id table in ``_ids_arr`` and
        # leaves ``_id_map`` None; the list/dict materialise on first use.
        # Every code path uses ``self._ids`` / ``self._id_to_row``.
        self._ids_list: list[str] | None = []
        self._ids_arr = None           # np.ndarray[S*] | None
        self._id_map: dict[str, int] | None = {}
        # Sorted probe over the raw id table: read-only id lookups on a
        # lazily loaded gallery binary-search the fixed-width bytes
        # instead of building the str dict. Dropped once the dict exists.
        self._ids_sorted = None        # np.ndarray[S*] | None
        self._ids_order = None         # np.ndarray[int64] | None
        # Tombstone deletes: rows are masked dead in place (the device
        # mirrors stay valid — only the cached filter masks refresh) and
        # physically reclaimed by a lazy compaction.
        self._alive = np.ones(capacity, dtype=bool)
        self._n_dead = 0
        # Set when a threshold-crossing delete deferred compaction;
        # cleared by compact().
        self._compact_due = False
        # Monotonic write sequence: bumps on every mutation. Cheap
        # staleness probe for consumers of derived state (the serving
        # endpoint's delegate matrix).
        self._wseq = 0
        # Incremental-snapshot tracking (persist.save_gallery): point ids
        # written/deleted since the last save, rows tombstoned since then,
        # and whether live row numbering still matches the base snapshot
        # (compaction renumbers).
        self._snap_dirty: set[str] = set()
        self._snap_deleted: set[str] = set()
        self._snap_dead_rows: set[int] = set()
        self._snap_rows_valid = True
        self._snap_root: str | None = None  # root of the current base
        self._snap_id: str | None = None    # base snapshot identity
        self._snap_seq = 0                  # last delta sequence number
        # Device mirrors (lazy per tier, patched INCREMENTALLY after small
        # writes — see _sync_mirrors). All share one padded row count.
        self._padded = 0
        self._dev_f32: torch.Tensor | None = None   # normalised f32
        self._dev_bf16: torch.Tensor | None = None  # normalised bf16
        self._dev_int8: torch.Tensor | None = None  # quantised scan tier
        # int4 tier: (packed [N, D/2] int8, per-row scales [N] f32)
        self._dev_int4: tuple[torch.Tensor, torch.Tensor] | None = None
        # Host rows [0, _synced) are reflected in the mirrors except for
        # the contiguous dirty range [_dirty_lo, _dirty_hi).
        self._synced = 0
        self._dirty_lo = 0
        self._dirty_hi = 0
        # Guards LAZY builds under concurrent readers: mirror and view
        # builds and syncs, pending-op replays, mask builds, the id
        # materialisations. Reentrant: the build paths nest.
        self._view_mut = threading.RLock()
        # Device filter masks of the mirrors (live AND filter), keyed by
        # canonical filter; cleared on writes.
        self._masks = _MaskCache(self._view_mut, 128)
        # The int8 tier's chain as CUDA graphs over the mirrors above;
        # cleared wherever the mirrors are rebuilt.
        self._int8_graphs = search_lib.Int8ScanGraphs()
        # The two WRITABLE serving views, built lazily and kept in sync
        # through their pending-op logs (row sets from upserts, mask rows
        # from deletes), so small writes patch tiles: the capacity view
        # (method="capacity", auto past CAPACITY_AUTO_BYTES; 64 masks, one
        # is 10.5 MB at 10.5M rows) and the sharded view (method=
        # "sharded", auto once a gallery mesh is attached — attach_mesh;
        # 128 masks, so that a caller filtering on any of 100 classes and
        # a few data types stays inside them).
        self._gallery_mesh = None
        self._cap = _ViewHolder(self._view_mut, 64)
        self._shard = _ViewHolder(self._view_mut, 128)
        self._views = (self._cap, self._shard)
        # Capacity-plane sidecar (gallery/planes.py), recorded by the
        # snapshot loader; checked against the snapshot identity when the
        # view is built (a stale sidecar falls back to the device build).
        self._planes_path: str | None = None
        # Resolved-path fallback index for get_by_path (lazy, maintained
        # incrementally across writes — see _patch_resolved). Pure string
        # normalisation, no per-row filesystem syscalls.
        self._resolved_paths: dict[str, int] | None = None
        self._resolved_back: dict[int, str] = {}   # row -> indexed key
        # Rows whose key lost to an earlier row (duplicate resolved
        # paths): promoted into the index when the winner is
        # deleted/overwritten, so a live duplicate stays findable.
        self._resolved_dups: dict[str, list[int]] = {}
        self._resolved_dirty: set[int] = set()     # rows to re-index
        self._resolved_hi = 0                      # rows [0, hi) indexed

    @property
    def _shard_view(self):
        """The live sharded view, or None."""
        return self._shard.view

    # ------------------------------------------------------------ ids
    @property
    def _ids(self) -> list[str]:
        if self._ids_list is None:
            with self._view_mut:
                if self._ids_list is not None:  # lost the build race
                    return self._ids_list
                arr = self._ids_arr
                # numpy 'S' access strips the trailing NUL padding.
                with _gc_paused():
                    built = ([b.decode("utf-8") for b in arr.tolist()]
                             if arr is not None else [])
                # Publish the list BEFORE dropping the raw table, so
                # concurrent _ids_at readers see one or the other.
                self._ids_list = built
                self._ids_arr = None
        return self._ids_list

    @_ids.setter
    def _ids(self, value) -> None:
        self._ids_list = list(value)
        self._ids_arr = None
        self._ids_sorted = None
        self._ids_order = None

    def _id_at(self, row: int) -> str:
        return self._ids_at([row])[0]

    def _ids_at(self, rows: list[int]) -> list[str]:
        """The ids of ``rows`` without materialising the full str list
        (search and retrieve results decode only the rows they return):
        one gather of a lazily loaded raw table, else list reads."""
        lst = self._ids_list
        if lst is None:
            arr = self._ids_arr
            if arr is not None:
                return [b.decode("utf-8") for b in arr[rows].tolist()]
            lst = self._ids  # materialised between the checks
        return [lst[r] for r in rows]

    def _row_of(self, pid: str) -> int | None:
        """Read-only id -> live row lookup. Prefers the materialised dict;
        on a lazily loaded gallery it binary-searches the raw id table.
        Tombstoned rows are skipped; a re-added id has two table entries
        and resolves to the alive one."""
        if self._id_map is not None:
            return self._id_map.get(pid)
        arr = self._ids_arr
        if arr is None:  # ids materialised but map not: build the map
            return self._id_to_row.get(pid)
        if self._ids_sorted is None or \
                len(self._ids_sorted) != len(arr):
            with self._view_mut:
                if self._ids_sorted is None or \
                        len(self._ids_sorted) != len(arr):
                    order = np.argsort(arr, kind="stable")
                    self._ids_order = order
                    self._ids_sorted = arr[order]
        b = pid.encode("utf-8")
        if len(b) > arr.dtype.itemsize:
            return None
        lo = int(np.searchsorted(self._ids_sorted, b, side="left"))
        hi = int(np.searchsorted(self._ids_sorted, b, side="right"))
        for i in range(lo, hi):
            row = int(self._ids_order[i])
            if self._alive[row]:
                return row
        return None

    @property
    def _id_to_row(self) -> dict[str, int]:
        if self._id_map is None:
            with self._view_mut:
                return self._build_id_map()
        return self._id_map

    def _build_id_map(self) -> dict[str, int]:
        # Body of the lazy _id_to_row build, under _view_mut.
        if self._id_map is None:
            with _gc_paused():
                ids = self._ids
                m = dict(zip(ids, range(len(ids))))
                if self._n_dead:
                    # Drop tombstoned rows; a re-added id maps to its LIVE
                    # row (later wins in the zip), so only entries still
                    # pointing at a dead row go.
                    for r in np.nonzero(~self._alive[: len(ids)])[0]:
                        pid = ids[int(r)]
                        if m.get(pid) == int(r):
                            del m[pid]
                self._id_map = m
            self._ids_sorted = None  # the dict supersedes the probe
            self._ids_order = None
        return self._id_map

    @_id_to_row.setter
    def _id_to_row(self, value) -> None:
        self._id_map = value

    # ------------------------------------------------------------ size
    @property
    def _nrows(self) -> int:
        """Physical row count including tombstoned rows (mirror and mask
        sizing); ``len(self)`` is the LIVE point count."""
        if self._ids_list is None and self._ids_arr is not None:
            return int(self._ids_arr.shape[0])  # no materialisation
        return len(self._ids)

    def __len__(self) -> int:
        return self._nrows - self._n_dead

    def _mask_live(self, flt: Filter | None) -> np.ndarray:
        """Filter mask over physical rows, with tombstoned rows excluded —
        the one mask every read path uses."""
        m = self._payloads.mask(flt)
        if self._n_dead:
            m = m & self._alive[: len(m)]
        return m

    def count(self, flt: Filter | None = None) -> int:
        if flt is None:
            return len(self)
        return int(self._mask_live(flt).sum())

    @property
    def write_seq(self) -> int:
        """Monotonic mutation counter (upsert/delete/compact). Consumers
        caching derived state compare this to detect staleness."""
        return self._wseq

    # ------------------------------------------------------------ writes
    def _ensure_capacity(self, extra: int) -> None:
        # _nrows, not len(self._ids): growth must not materialise a lazily
        # loaded id table.
        need = self._nrows + extra
        if need <= self._capacity:
            return
        new_cap = self._capacity
        while new_cap < need:
            new_cap *= 2
        if self._vectors_path and isinstance(self._vectors, np.memmap):
            # Grow the backing file in place: flush dirty pages, extend,
            # remap. No 2x transient RAM, no data copy.
            self._vectors.flush()
            del self._vectors  # release the old mapping before resize
            with open(self._vectors_path, "r+b") as f:
                f.truncate(new_cap * self.dim * 4)
            self._vectors = np.memmap(self._vectors_path,
                                      dtype=np.float32, mode="r+",
                                      shape=(new_cap, self.dim))
        else:
            vecs = np.zeros((new_cap, self.dim), dtype=np.float32)
            vecs[: self._capacity] = self._vectors
            self._vectors = vecs
        alive = np.ones(new_cap, dtype=bool)
        alive[: self._capacity] = self._alive
        self._alive = alive
        self._payloads.grow(new_cap)
        self._capacity = new_cap

    def upsert(
        self,
        ids: Sequence[str],
        vectors: np.ndarray | Sequence[Sequence[float]],
        payloads: Sequence[Payload | dict],
    ) -> int:
        """Insert-or-replace a batch of points; returns number written."""
        if len(ids) == 0:
            return 0
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        if vectors.shape != (len(ids), self.dim):
            raise ValueError(
                f"vectors shape {vectors.shape} != ({len(ids)}, {self.dim})"
            )
        if len(payloads) != len(ids):
            raise ValueError("payloads/ids length mismatch")
        pls = [Payload.from_dict(p) if isinstance(p, dict) else p
               for p in payloads]
        if len(set(ids)) != len(ids):
            # Duplicate ids within one batch: the last occurrence's VALUES
            # win, insertion order follows the FIRST occurrence.
            last = {pid: i for i, pid in enumerate(ids)}
            seen: set[str] = set()
            order = []
            for pid in ids:
                if pid not in seen:
                    seen.add(pid)
                    order.append(last[pid])
            ids = [ids[i] for i in order]
            vectors = vectors[order]
            pls = [pls[i] for i in order]
        old_len = len(self._ids)
        rows = np.empty(len(ids), dtype=np.int64)
        new_pids: list[str] = []
        for i, pid in enumerate(ids):
            row = self._id_to_row.get(pid)
            if row is None:
                row = old_len + len(new_pids)
                new_pids.append(pid)
            rows[i] = row
        # Grow only for genuinely NEW rows, BEFORE any state mutation: a
        # failed grow leaves no phantom ids without backing rows, and an
        # overwrite on a snapshot-adopted buffer (no headroom) reallocates
        # nothing.
        self._ensure_capacity(len(new_pids))
        for j, pid in enumerate(new_pids):
            self._ids.append(pid)
            self._id_to_row[pid] = old_len + j
        if (rows[0] == old_len and rows[-1] == old_len + len(rows) - 1
                and len(self._ids) == old_len + len(rows)):
            # Pure append (the bulk-ingest path): a slice assignment
            # streams sequentially into a disk-backed memmap.
            self._vectors[old_len: old_len + len(rows)] = vectors
        else:
            self._vectors[rows] = vectors
        self._payloads.set_rows(rows, pls)
        # Only OVERWRITES of present rows enter the dirty range; the
        # appended tail is tracked by _synced < n.
        existing = rows[rows < old_len]
        if existing.size:
            self._mark_dirty(int(existing.min()), int(existing.max()) + 1)
        op = None
        if any(h.view is not None for h in self._views):
            # EXACT row sets, not covering ranges: replaying a covering
            # span would mark every row in between valid, reviving the
            # tombstones inside it.
            written = np.unique(rows)
            if len(self._ids) > old_len:
                written = np.union1d(
                    written, np.arange(old_len, len(self._ids)))
            op = ("rows", written)
        self._note_write(op)
        self._patch_resolved(rows)
        self._wseq += 1
        if self._snap_id is not None:
            # Dirty tracking feeds DELTA saves only: before the first base
            # snapshot every save is a full rewrite.
            self._snap_dirty.update(ids)
            self._snap_deleted.difference_update(ids)  # re-added points
        return len(ids)

    def upsert_points(
        self, points: Iterable[tuple[str, np.ndarray, Payload]]
    ) -> int:
        pts = list(points)
        if not pts:
            return 0
        ids = [p[0] for p in pts]
        vecs = np.stack([np.asarray(p[1], dtype=np.float32) for p in pts])
        pls = [p[2] for p in pts]
        return self.upsert(ids, vecs, pls)

    def delete(self, ids: Sequence[str] | None = None,
               flt: Filter | None = None) -> int:
        """Delete by explicit IDs or by filter; returns number removed.

        Deletes TOMBSTONE: the row is masked dead in place and vanishes
        from every read path at once, but the device mirrors are NOT
        rebuilt (only the cached filter masks refresh), so a delete plus
        a re-query costs a mask build, not a mirror upload. ``compact()``
        reclaims the space once the dead fraction passes
        _COMPACT_DEAD_FRACTION."""
        n = self._nrows
        drop = np.zeros(n, dtype=bool)
        if ids is not None:
            for pid in ids:
                row = self._id_to_row.get(pid)
                if row is not None:
                    drop[row] = True
        if flt is not None:
            drop |= self._mask_live(flt)
        drop &= self._alive[:n]
        if not drop.any():
            return 0
        dropped = [int(r) for r in np.nonzero(drop)[0]]
        removed = len(dropped)
        self._alive[:n][drop] = False
        self._n_dead += removed
        back = self._resolved_back
        for r in dropped:
            pid = self._ids[r]
            if self._snap_id is not None:  # delta tracking (see upsert)
                self._snap_deleted.add(pid)
                self._snap_dirty.discard(pid)
                self._snap_dead_rows.add(r)
            if self._id_to_row.get(pid) == r:
                del self._id_to_row[pid]
            self._payloads.clear_path(r)
            self._resolved_dirty.discard(r)
            key = back.pop(r, None)
            if key is not None:
                self._resolved_remove(r, key)
        self._note_write(("mask", dropped))  # the mirrors still hold
        self._wseq += 1
        if (self._n_dead >= self._COMPACT_DEAD_MIN
                and self._n_dead >= self._COMPACT_DEAD_FRACTION * n):
            if (any(h.view is not None for h in self._views)
                    or n >= self._COMPACT_INLINE_MAX_ROWS):
                # Backpressure: compacting here would rebuild every mirror
                # and the capacity or sharded view mid-request. Flag it for
                # maintain() and keep serving off tombstones.
                if not self._compact_due:
                    self._compact_due = True
                    print(f"[gallery] {self.name}: {self._n_dead}/{n} "
                          f"rows dead — compaction deferred; call "
                          f"maintain() in a maintenance window",
                          file=sys.stderr)
            else:
                self.compact()
        return removed

    def warm(self, k: int = 10,
             filters: Sequence[Filter] = ()) -> float:
        """Pre-pay the first query's costs now: build the auto serving
        tier's device state (the sharded or capacity view, or the mirrors)
        and the
        device masks of ``filters``, so the first client query is steady
        state. Returns wall seconds; a no-op on an empty collection."""
        t0 = time.perf_counter()
        if len(self):
            q = np.asarray(self._vectors[:1], np.float32)  # a real row
            k_eff = min(k, len(self))
            # exact=False follows the auto route; the f32 mirror of
            # exact=True is warmed too where that route is a mirror (under
            # a mesh or at capacity scale an exact search raises or never
            # runs through this store's mirrors).
            auto, _ = self._route(self._nrows, self.dim, self.distance,
                                  False, None,
                                  self._gallery_mesh is not None,
                                  self.device.type)
            exact_fits = auto not in ("sharded", "capacity")
            for exact in ((False, True) if exact_fits else (False,)):
                self.search(q, k=k_eff, exact=exact)
                for flt in filters:
                    self.search(q, k=k_eff, flt=flt, exact=exact)
        return time.perf_counter() - t0

    def maintain(self, force: bool = False) -> int:
        """Run deferred maintenance (physical compaction) now: deletes past
        the dead-row threshold on large galleries, or with a live capacity
        view, defer compaction to here. ``force=True`` compacts even below
        the threshold. Returns rows reclaimed."""
        if force or self._compact_due:
            return self.compact()
        return 0

    def compact(self) -> int:
        """Physically reclaim tombstoned rows (invalidates the device
        mirrors — rows renumber). Returns rows reclaimed; a no-op when
        nothing is dead."""
        self._compact_due = False
        if self._n_dead == 0:
            return 0
        n = self._nrows
        keep = self._alive[:n].copy()
        n_new = int(keep.sum())
        self._vectors[:n_new] = self._vectors[:n][keep]
        self._payloads.compact(keep)
        new_ids: list[str] = []
        new_map: dict[str, int] = {}
        for i, pid in enumerate(self._ids):
            if keep[i]:
                new_map[pid] = len(new_ids)
                new_ids.append(pid)
        self._ids = new_ids
        self._id_to_row = new_map
        self._alive[:n] = True
        reclaimed = self._n_dead
        self._n_dead = 0
        self._wseq += 1
        # Row numbering no longer matches the base snapshot: later delta
        # saves fall back to id-keyed ops.
        self._snap_rows_valid = False
        self._snap_dead_rows.clear()
        self._invalidate_mirrors()  # compaction reshuffles rows
        return reclaimed

    # ------------------------------------------------------------ reads
    def _records(self, rows, with_vectors: bool,
                 scores: list[float] | None = None) -> list[Record]:
        """The Records of ``rows`` (any int sequence or array), in order,
        with ``scores`` beside them when given: ids, payloads and vectors
        each read in bulk. The vectors are one gather, never views of the
        store's memory."""
        rows = np.asarray(rows, dtype=np.int64)
        if len(rows) > 65536:
            _ = self._ids                   # bulk: one decode pass,
            self._payloads._ensure_paths()  # one split — beats per-row
        ids = self._ids_at(rows.tolist())
        nothing = [None] * len(ids)
        return list(map(
            Record, ids, self._payloads.get_rows(rows),
            list(self._vectors[rows]) if with_vectors else nothing,
            nothing if scores is None else scores))

    def retrieve(self, ids: Sequence[str], with_vectors: bool = True
                 ) -> list[Record]:
        """Records of the given ids, in order; unknown or deleted ids are
        skipped."""
        # _row_of probes a lazily loaded id table (the restart path).
        rows = [row for row in map(self._row_of, ids) if row is not None]
        return self._records(rows, with_vectors)

    def get_by_path(self, img_path: str, with_vectors: bool = True
                    ) -> Record | None:
        """O(1) lookup by exact img_path (33_run_all_experiments.py:96-110).

        Falls back to RESOLVED-path matching on an exact miss: the embed
        run and the experiment run may spell the same file differently
        (absolute vs relative, ``./`` prefix, another CWD) — point IDs
        already resolve (utils.ids), so the path index must too or every
        lookup misses and the result CSV comes out empty."""
        row = self._payloads.row_by_path(img_path)
        if row is None:
            row = self._resolved_row(img_path)
        if row is None:
            return None
        return self._records([row], with_vectors)[0]

    @staticmethod
    def _resolve_key(p: str) -> str:
        """Pure-string path normalisation (absolutise + collapse ``.``/
        ``..``/``//``): unifies the abs-vs-relative and ``./`` spellings
        without a filesystem call per row (symlink aliases are the one
        case this does not unify)."""
        return os.path.normpath(os.path.abspath(p))

    def _resolved_remove(self, r: int, key: str) -> None:
        """Detach row ``r`` from ``key``; if it was the index winner,
        promote the next LIVE duplicate so a shared resolved path stays
        findable after its first row is deleted or overwritten."""
        idx, dups = self._resolved_paths, self._resolved_dups
        if idx is None:
            return
        if idx.get(key) == r:
            del idx[key]
            lst = dups.get(key)
            while lst:
                cand = lst.pop(0)
                if self._alive[cand]:
                    idx[key] = cand
                    break
            if lst is not None and not lst:
                dups.pop(key, None)
        else:
            lst = dups.get(key)
            if lst is not None:
                if r in lst:
                    lst.remove(r)
                if not lst:
                    dups.pop(key, None)

    def _index_resolved_rows(self, rows: Iterable[int]) -> None:
        idx, back = self._resolved_paths, self._resolved_back
        for r in rows:
            old = back.pop(r, None)
            if old is not None:
                self._resolved_remove(r, old)
            if not self._alive[r]:
                continue
            p = self._payloads.path_of(r)
            if not p:
                continue
            key = self._resolve_key(p)
            if key not in idx:  # first row wins on duplicate paths
                idx[key] = r
            else:
                self._resolved_dups.setdefault(key, []).append(r)
            back[r] = key

    def _patch_resolved(self, rows: np.ndarray) -> None:
        """Record overwritten rows for incremental re-index (appends are
        covered by the _resolved_hi watermark). Past a threshold a lazy
        full rebuild is cheaper than patching row by row."""
        if self._resolved_paths is None:
            return
        self._resolved_dirty.update(
            int(r) for r in rows if r < self._resolved_hi)
        if len(self._resolved_dirty) > 65536:
            self._reset_resolved()

    def _reset_resolved(self) -> None:
        self._resolved_paths = None
        self._resolved_back = {}
        self._resolved_dups = {}
        self._resolved_dirty = set()
        self._resolved_hi = 0

    def _resolved_row(self, img_path: str) -> int | None:
        """Resolved-path fallback index (lazy; patched incrementally),
        built under ``_view_mut`` so concurrent readers never index a row
        twice."""
        with self._view_mut:
            n = self._nrows
            if self._resolved_paths is None:
                self._reset_resolved()
                self._resolved_paths = {}
            if self._resolved_dirty:
                self._index_resolved_rows(sorted(self._resolved_dirty))
                self._resolved_dirty.clear()
            if self._resolved_hi < n:
                self._index_resolved_rows(range(self._resolved_hi, n))
                self._resolved_hi = n
            return self._resolved_paths.get(self._resolve_key(img_path))

    def scroll(
        self,
        flt: Filter | None = None,
        limit: int = 10,
        offset: int = 0,
        with_vectors: bool = False,
    ) -> tuple[list[Record], int | None]:
        """Paginated filtered listing in insertion order: (records,
        next_offset), next_offset None when exhausted (Qdrant's scroll)."""
        if limit < 1:
            # limit=0 would return next_offset == offset: a pager looping
            # on next_offset would spin forever.
            raise ValueError(f"limit must be >= 1, got {limit}")
        if offset < 0:
            raise ValueError(f"offset must be >= 0, got {offset}")
        rows = np.nonzero(self._mask_live(flt))[0]
        records = self._records(rows[offset: offset + limit], with_vectors)
        next_offset = offset + limit if offset + limit < len(rows) else None
        return records, next_offset

    def scroll_all(
        self,
        flt: Filter | None = None,
        with_vectors: bool = False,
    ) -> list[Record]:
        """ALL records matching a filter, in insertion order (one mask
        evaluation, no page-size ceiling)."""
        rows = np.nonzero(self._mask_live(flt))[0]
        return self._records(rows, with_vectors)

    def distinct(self, fieldname: str, flt: Filter | None = None
                 ) -> list:
        """Sorted distinct values of a dictionary-encoded field among rows
        matching the filter."""
        cols = self._payloads
        if fieldname not in cols._CODED:
            raise KeyError(f"not a coded field: {fieldname}")
        mask = self._mask_live(flt)
        codes = np.unique(cols._cols[fieldname][: self._nrows][mask])
        decode = cols._decode[fieldname]
        vals = [decode[c] for c in codes if c >= 0]
        # None is a legal stored value (delegate_type on non-delegate
        # points) and must not blow up the sort against str.
        return sorted((v for v in vals if v is not None)) + (
            [None] if any(v is None for v in vals) else [])

    def vectors_matching(self, flt: Filter | None = None) -> np.ndarray:
        """All vectors matching a filter as one [M, D] float32 array."""
        mask = self._mask_live(flt)
        return self._vectors[: self._nrows][mask].copy()

    # ------------------------------------------------------------ mirrors
    def _invalidate_mirrors(self) -> None:
        # Compaction renumbers rows: the resolved-path index, the mirrors
        # and the capacity view cannot be patched across it.
        self._reset_resolved()
        self._padded = 0
        self._dev_f32 = self._dev_bf16 = self._dev_int8 = None
        self._dev_int4 = None
        self._int8_graphs.clear()
        self._synced = 0
        self._dirty_lo = self._dirty_hi = 0
        self._masks.clear()
        for h in self._views:
            h.drop()

    def _note_write(self, op) -> None:
        """A write changed payloads or validity: every cached device mask
        goes, and each live view queues ``op`` (None: nothing to queue)."""
        self._masks.clear()
        for h in self._views:
            h.note(op)

    def _mark_dirty(self, lo: int, hi: int) -> None:
        """Record a host-row write; mirrors patch the range at next sync
        (the resolved-path index is patched by _patch_resolved)."""
        if self._dirty_hi > self._dirty_lo:
            self._dirty_lo = min(self._dirty_lo, lo)
            self._dirty_hi = max(self._dirty_hi, hi)
        else:
            self._dirty_lo, self._dirty_hi = lo, hi

    def _normalized_rows(self, lo: int, hi: int, out_rows: int
                         ) -> torch.Tensor:
        """Host rows [lo, hi) zero-padded to ``out_rows`` rows, on the
        device: L2-normalised for cosine galleries, raw for the other
        metrics (normalising would change dot/euclid/manhattan). Always a
        fresh host buffer: ``torch.from_numpy`` would alias ``_vectors``,
        which later writes mutate."""
        buf = np.zeros((out_rows, self.dim), dtype=np.float32)
        if hi > lo:
            rows = self._vectors[lo:hi]
            if self.distance == "cosine":
                norms = np.linalg.norm(rows, axis=1, keepdims=True)
                rows = rows / np.maximum(norms, 1e-12)
            buf[: hi - lo] = rows
        return torch.from_numpy(buf).to(self.device)

    def _sync_mirrors(self, f32: bool = False, bf16: bool = False,
                      i8: bool = False) -> None:
        # Concurrent readers may race into the lazy build; one builds,
        # the rest wait.
        with self._view_mut:
            self._sync_mirrors_locked(f32=f32, bf16=bf16, i8=i8)

    def _sync_mirrors_locked(self, f32: bool = False, bf16: bool = False,
                             i8: bool = False) -> None:
        n = self._nrows
        if search_lib.pad_rows(n) > self._padded:
            # Grow geometrically so interleaved write/query patterns pay
            # O(log N) full rebuilds, not one per crossing of a 256 line.
            # The int8 kernel masks its ragged tile, so no tile multiple.
            self._padded = search_lib.pad_rows(max(n, 2 * self._padded))
            self._dev_f32 = self._dev_bf16 = self._dev_int8 = None
            self._dev_int4 = None
            self._int8_graphs.clear()
            self._masks.clear()
        # The int8 tier rescores from the f32 mirror, so i8 implies f32.
        if ((f32 or i8) and self._dev_f32 is None) or (
                bf16 and self._dev_bf16 is None and self._dev_f32 is None):
            # One host normalisation pass + ONE f32 upload; other tiers
            # derive on the device.
            self._dev_f32 = self._normalized_rows(0, n, self._padded)
            self._synced = n
            self._dirty_lo = self._dirty_hi = 0
        if bf16 and self._dev_bf16 is None:
            self._dev_bf16 = self._dev_f32.to(torch.bfloat16)
        if i8 and self._dev_int8 is None:
            self._dev_int8 = search_lib.quantize_rows_int8(self._dev_f32)
        # Patch what changed since the mirrors were built: the dirty
        # overwrite range and the appended tail, as TWO DISJOINT ranges
        # (one covering span would turn "overwrite row 0 + append" into a
        # full re-push).
        lo = self._dirty_lo
        hi = min(self._dirty_hi, self._synced)
        if hi > lo:
            self._patch_mirrors(lo, hi)
        if n > self._synced:
            self._patch_mirrors(self._synced, n)
        self._synced = n
        self._dirty_lo = self._dirty_hi = 0

    def _patch_mirrors(self, lo: int, hi: int) -> None:
        """Push host rows [lo, hi) into every existing mirror in place,
        in fixed-size chunks."""
        n = self._nrows
        chunk = min(self._SYNC_CHUNK, self._padded)
        start = (lo // chunk) * chunk
        while start < hi:
            s = min(start, self._padded - chunk)
            upd = self._normalized_rows(s, min(s + chunk, n), chunk)
            if self._dev_f32 is not None:
                self._dev_f32[s: s + chunk] = upd
            if self._dev_bf16 is not None:
                self._dev_bf16[s: s + chunk] = upd.to(torch.bfloat16)
            if self._dev_int8 is not None:
                self._dev_int8[s: s + chunk] = \
                    search_lib.quantize_rows_int8(upd)
            if self._dev_int4 is not None:
                packed, scales = self._dev_int4
                packed[s: s + chunk], scales[s: s + chunk] = \
                    search_lib.pack_rows_int4(upd)
            start += chunk

    def _device_mask(self, flt: Filter | None) -> torch.Tensor:
        """Device-resident row mask (live AND filter) at the mirrors'
        padding, cached per filter so a repeated filter costs no host mask
        build or upload. Writes clear the cache; the mirrors stay as they
        are."""
        def build():
            buf = np.zeros(self._padded, dtype=bool)
            buf[: self._nrows] = self._mask_live(flt)  # tombstones out
            return torch.from_numpy(buf).to(self.device)

        return self._masks.fetch(None if flt is None else flt.cache_key(),
                                 self._padded, build)

    # ------------------------------------------------------ capacity tier
    def _build_capacity_view(self) -> CapacitySearcher:
        """The capacity view from a matching planes sidecar, else from the
        host rows, with room for an eighth more rows."""
        n = self._nrows
        view = self._planes_sidecar_view()
        return view if view is not None else CapacitySearcher(
            self._vectors[:n], self._alive[:n].copy(),
            headroom=max(4096, n // 8), device=self.device)

    def _planes_sidecar_view(self):
        """Restore the capacity view from a ``<name>.rbod.planes`` sidecar
        (gallery/planes.py) when one is recorded AND its snapshot identity
        matches this gallery's live state exactly (same base id, same
        delta seq, no unsaved churn, unrenumbered rows). Returns None (→
        the chunked device build) on any mismatch or read error."""
        if self._planes_path is None:
            return None
        try:
            hdr = planes.read_header(self._planes_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"[gallery] WARNING: unreadable planes sidecar "
                  f"{self._planes_path}: {e} — rebuilding",
                  file=sys.stderr)
            self._planes_path = None
            return None
        if not (self._snap_id is not None
                and hdr.get("base_id") == self._snap_id
                and hdr.get("seq") == self._snap_seq
                and hdr.get("n") == self._nrows
                and hdr.get("dim") == self.dim
                and self._snap_rows_valid
                and not self._snap_dirty and not self._snap_deleted
                and not self._snap_dead_rows):
            return None  # stale: the state moved past the sidecar
        try:
            _, bf16, packed, scales = planes.open_sections(
                self._planes_path)
            n = self._nrows
            return CapacitySearcher.from_host_planes(
                bf16, packed, scales, self._alive[:n].copy(), n,
                headroom=max(4096, n // 8), device=self.device)
        except (OSError, ValueError, KeyError) as e:
            # Torn/truncated sidecar or shape drift: the chunked build.
            print(f"[gallery] WARNING: planes sidecar restore failed "
                  f"({e}) — rebuilding from host rows",
                  file=sys.stderr)
            return None

    # ------------------------------------------------------ sharded tier
    def attach_mesh(self, mesh) -> None:
        """Serve this collection from rows sharded over ``mesh``'s
        ``gallery`` axis (``parallel.mesh``): searches then AUTO-route to
        the sharded tier (method=None → "sharded"), and writes keep the
        sharded view patched incrementally."""
        if sharded.AXIS not in mesh.shape:
            raise ValueError(
                f"mesh has no '{sharded.AXIS}' axis: {dict(mesh.shape)}")
        if self.distance != "cosine":
            raise ValueError(
                "the sharded tier serves cosine collections (rows are "
                "pre-normalised shard-side); detach or use the "
                "single-device tiers for other metrics")
        with self._view_mut:
            if mesh is not self._gallery_mesh:
                self._gallery_mesh = mesh
                # The old mesh's sharded view goes. Auto-routing now
                # targets the sharded tier, so a live single-device
                # capacity view would never be read again while every
                # write kept growing its pending-op log: it goes too; an
                # explicit method="capacity" search rebuilds it.
                for h in self._views:
                    h.drop()

    def detach_mesh(self) -> None:
        """Drop the mesh and the sharded view; searches fall back to the
        single-device tiers."""
        with self._view_mut:
            self._gallery_mesh = None
            self._shard.drop()

    def _build_shard_view(self) -> sharded.ShardedGallerySearcher:
        """The sharded view over the attached mesh, with room for an
        eighth more rows. Residency per shard decides its layout, as the
        single-device auto route decides: past the budget, bf16 + int4
        planes only."""
        if self._gallery_mesh is None:
            raise ValueError(
                "no gallery mesh attached — call attach_mesh(mesh) "
                "before method='sharded' searches")
        n = self._nrows
        n_shards = self._gallery_mesh.shape[sharded.AXIS]
        return sharded.ShardedGallerySearcher.from_gallery(
            self, self._gallery_mesh,
            capacity=self._over_budget(n / max(1, n_shards), self.dim),
            headroom=max(4096, n // 8))

    def _sharded_search(self, queries: np.ndarray, k: int,
                        flt: Filter | None, with_vectors: bool,
                        exact: bool, method: str | None
                        ) -> list[list[Record]]:
        with self._view_mut:
            view = self._shard.sync(self._build_shard_view, self._vectors)
            _, tier = self._route(self._nrows, self.dim, self.distance,
                                  exact, method, True, view.devices[0].type,
                                  shard_capacity=view.capacity)
            # The tier's lazy int8/int4 mirrors build under the lock too:
            # two readers never build one twice or read half of one.
            view.ensure_mirror(tier)
        k_eff = min(k, len(self))
        scores, idx = view.search(
            queries, k=k_eff, exact=exact, method=tier,
            extra_mask=self._shard.mask(view, flt, self._payloads))
        return self._rows_to_records(scores, idx, k_eff, with_vectors)

    # ------------------------------------------------------------ search
    def _rows_to_records(self, scores: np.ndarray, idx: np.ndarray,
                         k_eff: int, with_vectors: bool
                         ) -> list[list[Record]]:
        """Per-query Record hit lists from top-k scores/rows; a query's
        first NEG_INF score ends its hits (fewer matches than k). Shared
        by every search route; the hits of all queries are built in one
        ``_records`` call."""
        k = min(k_eff, scores.shape[1])
        scores, idx = scores[:, :k], idx[:, :k]
        keep = np.logical_and.accumulate(
            ~(scores <= search_lib.NEG_INF / 2), axis=1)
        hits = self._records(idx[keep], with_vectors, scores[keep].tolist())
        results, lo = [], 0
        for n in keep.sum(axis=1).tolist():
            results.append(hits[lo:lo + n])
            lo += n
        return results

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        flt: Filter | None = None,
        exact: bool = True,
        with_vectors: bool = False,
        method: str | None = None,
    ) -> list[list[Record]]:
        """Batched top-k under the collection's metric. ``queries`` is
        [Q, D] or [D].

        ``method``: "exact" (f32), "bf16" (bf16 scan, f32 scores), "int8"
        (int8 scan + exact f32 rescore of the top candidates), "int4"
        (half the int8 scan's bytes: per-row 4-bit packing, scale-
        compensated in the scan, the same f32 rescore — exact hit scores,
        a top-k SET approximate at the margin; even dims only), "capacity"
        (the bf16-rescore + int4-plane tier at ~2.5 bytes/dim residency,
        writable and kept in sync incrementally), "sharded" (the sharded
        tier over the mesh from ``attach_mesh``: a scan per shard and an
        O(shards × k) merge; its sub-tier from ``exact`` and scale, or
        pinned with "sharded_exact" / "sharded_bf16" / "sharded_int8" /
        "sharded_int4"), or None — sharded when a gallery mesh is attached
        (past the per-shard capacity budget only quantised planes are
        resident, so ``exact=True`` then raises); else exact when
        ``exact=True``; else auto: bf16 for the non-cosine metrics,
        capacity once the standard mirrors exceed CAPACITY_AUTO_BYTES,
        int8 on CUDA at ≥INT8_SCAN_MIN_ROWS rows, bf16 below. The
        quantised tiers serve cosine collections only.

        While tracing, a call is a ``search.call`` span; on the
        single-device routes it holds ``search.prep`` (mirrors, mask,
        upload and the scan's launches; on the int8 tier on CUDA, one
        replay of its graph), ``search.copy_back`` (the host's wait for the
        top-k) and ``search.records``.
        """
        with tracer.span("search.call"):
            return self._search(queries, k, flt, exact, with_vectors,
                                method)

    @classmethod
    def _over_budget(cls, rows: float, dim: int) -> bool:
        """Whether ``rows`` rows of ``dim`` outgrow the standard mirrors'
        budget (~5 bytes/dim) on one card, so that only the bf16 + int4
        capacity layout (even dims) is resident."""
        return dim % 2 == 0 and rows * dim * 5 > cls.CAPACITY_AUTO_BYTES

    @classmethod
    def _route(cls, rows: int, dim: int, distance: str, exact: bool,
               method: str | None, meshed: bool, device_type: str,
               shard_capacity: bool = False) -> tuple[str, str | None]:
        """Which tier serves a search → (route, sharded sub-tier), the
        route one of "exact", "bf16", "int8", "int4", "capacity" and
        "sharded", the sub-tier None off the sharded route. ``method`` as
        ``search`` takes it; ``meshed``: a gallery mesh is attached;
        ``device_type``: the type of the device that scans;
        ``shard_capacity``: the sharded view keeps the capacity layout
        only. Raises ValueError on a method string the store does not
        serve, or one the collection's metric or dim cannot take."""
        scan = ("int8" if rows >= cls.INT8_SCAN_MIN_ROWS
                and device_type == "cuda" else "bf16")
        if method is None:
            if meshed:
                # Mesh attached: the sharded tier IS the serving path (its
                # exact sub-tier equals single-device exact top-k, ties
                # broken by shard order).
                method = "sharded"
            elif exact:
                method = "exact"
            elif distance != "cosine":
                method = "bf16"  # int8 quantisation assumes unit rows
            elif cls._over_budget(rows, dim):
                # The standard mirrors stop fitting the card: serve
                # through the bf16 + int4 capacity tier.
                method = "capacity"
            else:
                method = scan
        if method == "sharded" or method.startswith("sharded_"):
            # A malformed "shardedfoo" falls through to the unknown-method
            # ValueError below (the HTTP API forwards method strings).
            tier = None
            if method != "sharded":
                tier = method[len("sharded_"):]
                if tier not in ("exact", "bf16", "int8", "int4"):
                    raise ValueError(f"unknown sharded tier {method!r}")
                if tier in ("int8", "int4") and distance != "cosine":
                    raise ValueError(
                        f"sharded tier {tier!r} requires a cosine "
                        "collection (the quantised tiers assume unit-norm "
                        "rows)")
            elif shard_capacity:
                if exact:
                    # The single-device analog fails loudly too; serving
                    # int4 here would break "exact means exact" on the
                    # one path where nobody opted into approximation.
                    raise ValueError(
                        "exact search is unavailable at this scale: the "
                        "sharded view keeps bf16+int4 planes only "
                        "(per-shard residency past CAPACITY_AUTO_BYTES). "
                        "Pass exact=False for the serving tier, or pin "
                        "method='sharded_bf16'/'sharded_int4'.")
                tier = "int4"
            else:
                tier = "exact" if exact else scan
            return "sharded", tier
        if method not in ("exact", "bf16", "int8", "int4", "capacity"):
            raise ValueError(
                f"unknown method {method!r}: expected one of "
                "'exact', 'bf16', 'int8', 'int4', 'capacity', "
                "'sharded[_<tier>]' (or None for auto)")
        if method in ("int8", "int4", "capacity") and distance != "cosine":
            raise ValueError(
                f"method={method!r} requires a cosine collection (the "
                "quantised tiers assume unit-norm rows)")
        if method in ("int4", "capacity") and dim % 2:
            raise ValueError(f"method={method!r} requires an even dim "
                             "(two dims pack per byte)")
        return method, None

    def _search(self, queries, k, flt, exact, with_vectors, method):
        n = self._nrows
        route, _ = self._route(n, self.dim, self.distance, exact, method,
                               self._gallery_mesh is not None,
                               self.device.type)
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if len(self) == 0:  # no LIVE points (all-tombstoned included)
            return [[] for _ in range(queries.shape[0])]
        if route == "sharded":
            # Mesh-resident rows, a scan per shard and the merge; never
            # touches the single-device mirrors. Its sub-tier is routed
            # once the view, and so its layout, is built.
            return self._sharded_search(queries, k, flt, with_vectors,
                                        exact, method)
        if route == "capacity":
            # Own device residency (bf16 + int4 planes, no f32 mirror);
            # never touches _sync_mirrors.
            with self._view_mut:
                view = self._cap.sync(self._build_capacity_view,
                                      self._vectors)
            k_eff = min(k, len(self))
            scores, idx = view.search(
                queries, k=k_eff,
                extra_mask=self._cap.mask(view, flt, self._payloads))
            return self._rows_to_records(scores, idx, k_eff, with_vectors)
        k_eff = min(k, n)
        with tracer.span("search.prep"):
            scores, idx = self._scan(queries, k_eff, flt, route)
        with tracer.span("search.copy_back"):
            scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        with tracer.span("search.records"):
            return self._rows_to_records(scores, idx, k_eff, with_vectors)

    def _scan(self, queries: np.ndarray, k_eff: int, flt: Filter | None,
              method: str) -> tuple[torch.Tensor, torch.Tensor]:
        """The single-device routes up to the top-k on the device: the
        mirrors synced, the filter's mask, the upload and the scan's
        launches → (scores, rows), still on the device."""
        self._sync_mirrors(f32=(method in ("exact", "int8", "int4")),
                           bf16=(method == "bf16"), i8=(method == "int8"))
        mask = self._device_mask(flt)
        if method == "int8":
            # The queries go straight into the graph's input on CUDA.
            return self._int8_graphs.topk(
                queries, self._dev_int8, self._dev_f32, mask, k=k_eff,
                rescore=search_lib.rescore_depth(k_eff, self._padded))
        q = upload(queries, self.device)  # may be a read-only request buffer
        g = self._dev_f32 if method == "exact" else self._dev_bf16
        if method == "int4":
            if self._dev_int4 is None:
                with self._view_mut:
                    if self._dev_int4 is None:
                        # Packed on the device from the (already patched)
                        # f32 mirror.
                        self._dev_int4 = search_lib.pack_rows_int4(
                            self._dev_f32)
            packed, scales = self._dev_int4
            scores, idx = search_lib.int4_scan_topk(
                q, packed, scales, self._dev_f32, mask, k=k_eff,
                rescore=search_lib.rescore_depth(k_eff, self._padded))
        elif self.distance == "cosine":
            scores, idx = search_lib.masked_cosine_topk(
                q, g, mask, k=k_eff, exact=(method == "exact"),
                gallery_normalized=True)
        else:
            scores, idx = search_lib.masked_metric_topk(
                q, g, mask, k=k_eff, distance=self.distance,
                exact=(method == "exact"))
        return scores, idx

    # ------------------------------------------------------------ export
    def to_arrays(self) -> dict[str, Any]:
        self.compact()  # exports are dense live-row views
        n = self._nrows
        return {
            "ids": list(self._ids),
            "vectors": self._vectors[:n].copy(),
            "payloads": [p.to_dict()
                         for p in self._payloads.get_rows(np.arange(n))],
            "dim": self.dim,
            "distance": self.distance,
        }

    @staticmethod
    def from_arrays(name: str, data: dict[str, Any],
                    device: str | torch.device = "cuda") -> "Gallery":
        dim = int(data["dim"])
        g = Gallery(name, dim=dim,
                    capacity=max(1024, len(data["ids"])),
                    distance=data.get("distance", "cosine"), device=device)
        payloads = [Payload.from_dict(p) for p in data["payloads"]]
        if data["ids"]:
            g.upsert(data["ids"], data["vectors"], payloads)
        return g


class VectorStore:
    """Named-collection manager (the util/qdrant_manager.py equivalent);
    every collection lives on ``device``."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self._collections: dict[str, Gallery] = {}
        # Names whose snapshots go at the next save — only explicit
        # deletes/renames, never load failures (a collection skipped on
        # load must survive unrelated saves).
        self._tombstones: set[str] = set()
        # Store-level mesh: applied to every current and FUTURE cosine
        # collection (attach_mesh), so a sharded deployment configures
        # sharding once, not per collection.
        self._mesh = None

    def attach_mesh(self, mesh) -> int:
        """Attach a gallery mesh store-wide: every current cosine
        collection serves through the sharded tier, and collections created
        later inherit it. Returns the number attached now."""
        self._mesh = mesh
        n = 0
        for g in self._collections.values():
            if g.distance == "cosine":
                g.attach_mesh(mesh)
                n += 1
        return n

    def detach_mesh(self) -> None:
        self._mesh = None
        for g in self._collections.values():
            g.detach_mesh()

    def list_collections(self) -> list[tuple[str, int]]:
        """[(name, point_count)] — mirrors qdrant_manager.py:41-50."""
        return [(n, len(g)) for n, g in sorted(self._collections.items())]

    def create_collection(self, name: str, dim: int = 512,
                          distance: str = "cosine",
                          recreate: bool = True) -> Gallery:
        """Create (or recreate, matching ``recreate_collection`` semantics
        at qdrant_manager.py:82-85) a collection."""
        if name in self._collections and not recreate:
            raise KeyError(f"collection exists: {name}")
        g = Gallery(name, dim=dim, distance=distance, device=self.device)
        if self._mesh is not None and distance == "cosine":
            g.attach_mesh(self._mesh)
        self._collections[name] = g
        self._tombstones.discard(name)
        return g

    def get(self, name: str) -> Gallery:
        return self._collections[name]

    def __contains__(self, name: str) -> bool:
        return name in self._collections

    def rename_collection(self, old: str, new: str) -> None:
        """Copy-then-delete rename (qdrant_manager.py:90-102)."""
        if new in self._collections:
            raise KeyError(f"collection exists: {new}")
        g = self._collections.pop(old)
        g.name = new
        self._collections[new] = g
        self._tombstones.add(old)
        self._tombstones.discard(new)

    def delete_collection(self, name: str) -> None:
        del self._collections[name]
        self._tombstones.add(name)

    def delete_all_collections(self) -> int:
        n = len(self._collections)
        self._tombstones.update(self._collections)
        self._collections.clear()
        return n
