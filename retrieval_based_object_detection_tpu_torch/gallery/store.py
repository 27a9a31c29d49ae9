"""In-process vector gallery with Qdrant-equivalent semantics.

Payloads live host-side in columnar NumPy (``schema.PayloadColumns``),
vectors in a host float32 buffer mirrored lazily onto the device as padded,
L2-normalised tensors. Filters lower to a boolean row mask; the device does
one masked matmul (or the int8 scan) plus top-k.

This is the serving and experiment subset of the JAX package's
``gallery/store.py``: ``upsert``, ``count``, ``scroll``/``scroll_all``,
``distinct``, ``vectors_matching``, ``retrieve``, ``get_by_path`` (with the
resolved-path fallback), incrementally patched f32/bf16/int8/int4 device
mirrors, and ``search`` with methods exact/bf16/int8/int4 under the same
auto-routing and constants. What it leaves out raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.gallery import search as search_lib
from retrieval_based_object_detection_tpu_torch.gallery.schema import (
    Filter,
    Payload,
    PayloadColumns,
)
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet "
        f"(ROADMAP.md queue A, item {item})")


@dataclass
class Record:
    """One gallery point, as returned by scroll/search."""

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

    # Standard serving keeps ~5 bytes/dim resident (f32 + int8 mirrors);
    # past this budget a serving search routes to the capacity tier.
    CAPACITY_AUTO_BYTES = 8 << 30

    _SYNC_CHUNK = 4096  # rows per incremental device update

    def __init__(self, name: str, dim: int = 512, capacity: int = 1024,
                 distance: str = "cosine",
                 vectors_path: str | None = None,
                 device: str | torch.device = "cuda"):
        if distance not in ("cosine", "dot", "euclid", "manhattan"):
            raise ValueError(f"unsupported distance: {distance}")
        if distance != "cosine":
            raise _not_ported(f"distance={distance!r}", "A.2")
        if vectors_path:
            raise _not_ported("vectors_path (memmap vectors)", "A.3")
        self.name = name
        self.dim = dim
        self.distance = distance
        self.device = resolve_device(device)
        self._capacity = capacity
        self._vectors = np.zeros((capacity, dim), dtype=np.float32)
        self._payloads = PayloadColumns(capacity)
        self._ids: list[str] = []
        self._id_to_row: dict[str, int] = {}
        # Monotonic write sequence: bumps on every mutation. Cheap
        # staleness probe for consumers of derived state (the serving
        # endpoint's delegate matrix).
        self._wseq = 0
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
        # Device filter masks keyed by canonical filter; cleared on writes.
        self._mask_cache: dict[Any, torch.Tensor] = {}
        # Guards lazy mirror and mask builds under concurrent readers.
        self._view_mut = threading.RLock()
        # Resolved-path fallback index for get_by_path (lazy, maintained
        # incrementally across writes — see _patch_resolved). Pure string
        # normalisation, no per-row filesystem syscalls. The port has no
        # deletes yet, so every row is alive and the index needs no
        # liveness checks.
        self._resolved_paths: dict[str, int] | None = None
        self._resolved_back: dict[int, str] = {}   # row -> indexed key
        # Rows whose key lost to an earlier row (duplicate resolved
        # paths): promoted into the index when the winner is overwritten.
        self._resolved_dups: dict[str, list[int]] = {}
        self._resolved_dirty: set[int] = set()     # rows to re-index
        self._resolved_hi = 0                      # rows [0, hi) indexed

    # ------------------------------------------------------------ size
    @property
    def _nrows(self) -> int:
        return len(self._ids)

    def __len__(self) -> int:
        return self._nrows

    def count(self, flt: Filter | None = None) -> int:
        if flt is None:
            return len(self)
        return int(self._payloads.mask(flt).sum())

    @property
    def write_seq(self) -> int:
        """Monotonic mutation counter. Consumers caching derived state
        compare this to detect staleness."""
        return self._wseq

    # ------------------------------------------------------------ writes
    def _ensure_capacity(self, extra: int) -> None:
        need = self._nrows + extra
        if need <= self._capacity:
            return
        new_cap = self._capacity
        while new_cap < need:
            new_cap *= 2
        vecs = np.zeros((new_cap, self.dim), dtype=np.float32)
        vecs[: self._capacity] = self._vectors
        self._vectors = vecs
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
        # Grow BEFORE any state mutation: a failed grow leaves no phantom
        # ids without backing rows.
        self._ensure_capacity(len(new_pids))
        for j, pid in enumerate(new_pids):
            self._ids.append(pid)
            self._id_to_row[pid] = old_len + j
        self._vectors[rows] = vectors
        self._payloads.set_rows(rows, pls)
        # Only OVERWRITES of present rows enter the dirty range; the
        # appended tail is tracked by _synced < n.
        existing = rows[rows < old_len]
        if existing.size:
            self._mark_dirty(int(existing.min()), int(existing.max()) + 1)
        else:
            self._mask_cache.clear()  # appends change the validity mask
        self._patch_resolved(rows)
        self._wseq += 1
        return len(ids)

    def delete(self, ids: Sequence[str] | None = None,
               flt: Filter | None = None) -> int:
        raise _not_ported("Gallery.delete (tombstones)", "A.2")

    def compact(self) -> int:
        raise _not_ported("Gallery.compact", "A.2")

    def maintain(self, force: bool = False) -> int:
        raise _not_ported("Gallery.maintain", "A.2")

    def attach_mesh(self, mesh) -> None:
        raise _not_ported("the sharded tier (attach_mesh)", "A.6")

    # ------------------------------------------------------------ reads
    def _records(self, rows: np.ndarray, with_vectors: bool) -> list[Record]:
        return [
            Record(
                id=self._ids[int(r)],
                payload=self._payloads.get_row(int(r)),
                vector=self._vectors[r].copy() if with_vectors else None,
            )
            for r in rows
        ]

    def retrieve(self, ids: Sequence[str], with_vectors: bool = True
                 ) -> list[Record]:
        """Records of the given ids, in order; unknown ids are skipped."""
        out = []
        for pid in ids:
            row = self._id_to_row.get(pid)
            if row is None:
                continue
            out.append(Record(
                id=pid,
                payload=self._payloads.get_row(row),
                vector=self._vectors[row].copy() if with_vectors else None,
            ))
        return out

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
        return Record(
            id=self._ids[row],
            payload=self._payloads.get_row(row),
            vector=self._vectors[row].copy() if with_vectors else None,
        )

    @staticmethod
    def _resolve_key(p: str) -> str:
        """Pure-string path normalisation (absolutise + collapse ``.``/
        ``..``/``//``): unifies the abs-vs-relative and ``./`` spellings
        without a filesystem call per row (symlink aliases are the one
        case this does not unify)."""
        return os.path.normpath(os.path.abspath(p))

    def _resolved_remove(self, r: int, key: str) -> None:
        """Detach row ``r`` from ``key``; if it was the index winner,
        promote the next duplicate so a shared resolved path stays
        findable after its first row is overwritten."""
        idx, dups = self._resolved_paths, self._resolved_dups
        if idx.get(key) == r:
            del idx[key]
            lst = dups.get(key)
            if lst:
                idx[key] = lst.pop(0)
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
            self._resolved_paths = None

    def _resolved_row(self, img_path: str) -> int | None:
        """Resolved-path fallback index (lazy; patched incrementally),
        built under ``_view_mut`` so concurrent readers never index a row
        twice."""
        with self._view_mut:
            n = self._nrows
            if self._resolved_paths is None:
                self._resolved_paths = {}
                self._resolved_back = {}
                self._resolved_dups = {}
                self._resolved_dirty = set()
                self._resolved_hi = 0
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
        rows = np.nonzero(self._payloads.mask(flt))[0]
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
        rows = np.nonzero(self._payloads.mask(flt))[0]
        return self._records(rows, with_vectors)

    def distinct(self, fieldname: str, flt: Filter | None = None
                 ) -> list:
        """Sorted distinct values of a dictionary-encoded field among rows
        matching the filter."""
        cols = self._payloads
        if fieldname not in cols._CODED:
            raise KeyError(f"not a coded field: {fieldname}")
        mask = cols.mask(flt)
        codes = np.unique(cols._cols[fieldname][: self._nrows][mask])
        decode = cols._decode[fieldname]
        vals = [decode[c] for c in codes if c >= 0]
        # None is a legal stored value (delegate_type on non-delegate
        # points) and must not blow up the sort against str.
        return sorted((v for v in vals if v is not None)) + (
            [None] if any(v is None for v in vals) else [])

    def vectors_matching(self, flt: Filter | None = None) -> np.ndarray:
        """All vectors matching a filter as one [M, D] float32 array."""
        mask = self._payloads.mask(flt)
        return self._vectors[: self._nrows][mask].copy()

    # ------------------------------------------------------------ mirrors
    def _mark_dirty(self, lo: int, hi: int) -> None:
        """Record a host-row write; mirrors patch the range at next sync."""
        self._mask_cache.clear()
        if self._dirty_hi > self._dirty_lo:
            self._dirty_lo = min(self._dirty_lo, lo)
            self._dirty_hi = max(self._dirty_hi, hi)
        else:
            self._dirty_lo, self._dirty_hi = lo, hi

    def _normalized_rows(self, lo: int, hi: int, out_rows: int
                         ) -> torch.Tensor:
        """Host rows [lo, hi), L2-normalised, zero-padded to ``out_rows``,
        on the device. Always a fresh host buffer: ``torch.from_numpy``
        would alias ``_vectors``, which later writes mutate."""
        buf = np.zeros((out_rows, self.dim), dtype=np.float32)
        if hi > lo:
            rows = self._vectors[lo:hi]
            norms = np.linalg.norm(rows, axis=1, keepdims=True)
            buf[: hi - lo] = rows / np.maximum(norms, 1e-12)
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
            self._mask_cache.clear()
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
        """Device-resident row mask (valid AND filter), cached per filter
        so a repeated filter costs no host mask build or upload."""
        key = None if flt is None else flt.cache_key()
        cached = self._mask_cache.get(key)
        if cached is not None:
            return cached
        with self._view_mut:  # single build per filter across readers
            cached = self._mask_cache.get(key)
            if cached is not None:
                return cached
            buf = np.zeros(self._padded, dtype=bool)
            buf[: self._nrows] = self._payloads.mask(flt)
            mask = torch.from_numpy(buf).to(self.device)
            if len(self._mask_cache) >= 128:
                self._mask_cache.clear()
            self._mask_cache[key] = mask
            return mask

    def _rows_to_records(self, scores: np.ndarray, idx: np.ndarray,
                         k_eff: int, with_vectors: bool
                         ) -> list[list[Record]]:
        """Per-query Record hit lists from top-k scores/rows; a NEG_INF
        score ends a query's hits (fewer matches than k)."""
        results: list[list[Record]] = []
        for qi in range(scores.shape[0]):
            hits = []
            for j in range(min(k_eff, scores.shape[1])):
                if scores[qi, j] <= search_lib.NEG_INF / 2:
                    break
                row = int(idx[qi, j])
                hits.append(Record(
                    id=self._ids[row],
                    payload=self._payloads.get_row(row),
                    vector=self._vectors[row].copy()
                    if with_vectors else None,
                    score=float(scores[qi, j]),
                ))
            results.append(hits)
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
        """Batched cosine top-k. ``queries`` is [Q, D] or [D].

        ``method``: "exact" (f32), "bf16" (bf16 scan, f32 scores), "int8"
        (int8 scan + exact f32 rescore of the top candidates), "int4"
        (half the int8 scan's bytes: per-row 4-bit packing, scale-
        compensated in the scan, the same f32 rescore — exact hit scores,
        a top-k SET approximate at the margin; even dims only), or None —
        exact when ``exact=True``; else auto: capacity once the standard
        mirrors exceed CAPACITY_AUTO_BYTES (not ported: raises), int8 on
        CUDA at ≥INT8_SCAN_MIN_ROWS rows, bf16 below. "capacity" and
        "sharded[_<tier>]" are not ported and raise.
        """
        n = self._nrows
        if method is None:
            if exact:
                method = "exact"
            elif self.dim % 2 == 0 and n * self.dim * 5 > \
                    self.CAPACITY_AUTO_BYTES:
                method = "capacity"
            else:
                method = ("int8" if n >= self.INT8_SCAN_MIN_ROWS
                          and self.device.type == "cuda" else "bf16")
        if method == "capacity":
            raise _not_ported(f"method={method!r}", "A.4")
        if method == "sharded" or method.startswith("sharded_"):
            raise _not_ported(f"method={method!r}", "A.6")
        if method not in ("exact", "bf16", "int8", "int4"):
            raise ValueError(
                f"unknown method {method!r}: expected one of "
                "'exact', 'bf16', 'int8', 'int4' (or None for auto)")
        if method == "int4" and self.dim % 2:
            raise ValueError(f"method={method!r} requires an even dim "
                             "(two dims pack per byte)")
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if len(self) == 0:
            return [[] for _ in range(queries.shape[0])]
        self._sync_mirrors(f32=(method in ("exact", "int8", "int4")),
                           bf16=(method == "bf16"), i8=(method == "int8"))
        mask = self._device_mask(flt)
        k_eff = min(k, n)
        q = torch.from_numpy(queries).to(self.device)
        if method == "int4":
            rescore = min(max(8 * k_eff, 256), self._padded)
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
                rescore=rescore)
        elif method == "int8":
            rescore = min(max(8 * k_eff, 256), self._padded)
            scores, idx = search_lib.int8_scan_topk(
                q, self._dev_int8, self._dev_f32, mask, k=k_eff,
                rescore=rescore)
        else:
            g = self._dev_f32 if method == "exact" else self._dev_bf16
            scores, idx = search_lib.masked_cosine_topk(
                q, g, mask, k=k_eff, exact=(method == "exact"),
                gallery_normalized=True)
        return self._rows_to_records(scores.cpu().numpy(),
                                     idx.cpu().numpy(), k_eff, with_vectors)


class VectorStore:
    """Named-collection manager (the util/qdrant_manager.py equivalent);
    every collection lives on ``device``."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self._collections: dict[str, Gallery] = {}

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
        self._collections[name] = g
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

    def delete_collection(self, name: str) -> None:
        del self._collections[name]

    def delete_all_collections(self) -> int:
        n = len(self._collections)
        self._collections.clear()
        return n
