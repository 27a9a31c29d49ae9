"""Single-device capacity-mode serving view: int4 planes + bf16 rescore.

The Gallery's standard mirrors keep ~5 bytes/dim on the device (f32 rescore
rows + int8 scan rows). This view keeps ~2.5, which is what puts
10,485,760 x 512 rows on one card in 13.5 GB:

  * int4 packed planes + per-row scales    — N·D/2 + 4N bytes (the scan)
  * bf16 rescore mirror                     — 2·N·D bytes
  * bool row mask (validity + tombstones)   — N bytes

built CHUNK by chunk from the host rows (one [chunk, D] f32 upload at a
time, normalised, cast and packed on the device into the preallocated
planes), so peak device memory is the residency above plus one chunk.

Search: the int4 scan (kernel B3 on CUDA, ``search.int4_scan_topk``; its
plain version on CPU tensors) → top-``rescore`` candidates → rescore
against the bf16 mirror with f32 scores. Hit scores are the bf16 rows'
cosine; the top-k set is approximate at the margin (4-bit resolution).
For exactness use the Gallery's int8/f32 tiers at the sizes they fit.

The port of the JAX package's ``gallery/capacity.py``, which calls its
kernel only on a TPU and its unpack-and-dot twin elsewhere; this view calls
the scan on every device, as the port's int4 tier does.
"""

from __future__ import annotations

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.gallery import search as search_lib
from retrieval_based_object_detection_tpu_torch.gallery.store import upload
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)

_CHUNK = 1 << 18  # staging rows per upload (512 MB f32 at D=512)
# Incremental write granularity: rows re-packed per patched tile.
_TILE = 4096


def fill_planes(bf16: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor, staged: torch.Tensor,
                start: int) -> None:
    """Normalise one f32 chunk already on the planes' device and write its
    bf16 rows, packed int4 rows and scales at row ``start``."""
    rows = staged / torch.clamp(
        torch.linalg.vector_norm(staged, dim=1, keepdim=True), min=1e-12)
    p, s = search_lib.pack_rows_int4(rows)
    m = rows.shape[0]
    bf16[start: start + m] = rows.to(torch.bfloat16)
    packed[start: start + m] = p
    scales[start: start + m] = s


def _bf16_from_host(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """bf16 rows held on the host as their 16-bit patterns (any 2-byte
    dtype: a planes sidecar's uint16) → a bf16 tensor on ``device``."""
    bits = np.ascontiguousarray(rows).view(np.int16)
    return upload(bits, device).view(torch.bfloat16)


class CapacitySearcher:
    """Writable int4 + bf16 serving view over gallery rows (see the module
    docstring).

    Writes are incremental: ``upsert_rows`` / ``upsert`` patch only the
    affected fixed-size tiles (full tiles from the new rows; partial edge
    tiles read back the bf16 tile, overlay and re-pack — the int4 plane of
    the untouched rows is then re-quantised from their bf16 values, far
    below int4's own resolution). ``delete`` tombstones through the row
    mask without touching the planes."""

    def __init__(self, vectors: np.ndarray, mask: np.ndarray,
                 chunk: int = _CHUNK,
                 ids: list[str] | None = None,
                 headroom: int = 0,
                 device: str | torch.device = "cuda"):
        n, d = vectors.shape
        if d % 2:
            raise ValueError("capacity mode packs two dims per byte — "
                             "even dim required")
        self.device = resolve_device(device)
        self.n_rows = n
        self.dim = d
        # Rows padded to a chunk multiple (a multiple of 256, so the
        # patch tiles divide it), with ``headroom`` rows reserved for
        # appends (growing the planes later is a full device copy).
        chunk = max(256, (min(chunk, _CHUNK) // 256) * 256)
        self._padded = -(-(n + max(0, headroom)) // chunk) * chunk
        self.dev_bf16 = torch.zeros((self._padded, d), dtype=torch.bfloat16,
                                    device=self.device)
        self.dev_packed = torch.zeros((self._padded, d // 2),
                                      dtype=torch.int8, device=self.device)
        self.dev_scales = torch.zeros(self._padded, dtype=torch.float32,
                                      device=self.device)
        # Every chunk is filled, the zero tail too, as the JAX view fills
        # it: a zero row packs to bytes of 8 and a scale of 1e-12 / 7.
        for start in range(0, self._padded, chunk):
            staged = np.zeros((chunk, d), np.float32)
            hi = min(start + chunk, n)
            if hi > start:
                staged[: hi - start] = vectors[start:hi]
            self._fill(upload(staged, self.device), start)
        # Host shadow of the row mask (N bytes — trivial even at 10M):
        # mask writes mutate the shadow, then re-push only affected tiles.
        self._host_mask = np.zeros(self._padded, bool)
        self._host_mask[:n] = mask
        self.dev_mask = upload(self._host_mask, self.device)
        self.ids = ids  # optional row -> point-id mapping (from_gallery)
        self._id_to_row: dict[str, int] | None = None

    def _fill(self, staged: torch.Tensor, start: int) -> None:
        fill_planes(self.dev_bf16, self.dev_packed, self.dev_scales, staged,
                    start)

    @classmethod
    def from_device_planes(cls, bf16: torch.Tensor, packed: torch.Tensor,
                           scales: torch.Tensor, mask, n_rows: int,
                           ids: list[str] | None = None
                           ) -> "CapacitySearcher":
        """Wrap ALREADY-BUILT device planes (generated on the device, or
        restored) without a host-side fill pass. ``mask`` is a host bool
        array (or tensor) over the rows; the view keeps it as its host
        shadow.

        The plane row count must be a multiple of 256 (the smallest patch
        tile): the incremental write path patches fixed tiles that must
        divide the rows."""
        if int(bf16.shape[0]) % 256:
            raise ValueError(
                f"plane row count {int(bf16.shape[0])} is not a multiple "
                "of 256 — pad the planes (the incremental write path "
                "patches fixed tiles that must divide the row count)")
        obj = cls.__new__(cls)
        obj.device = bf16.device
        obj.n_rows = n_rows
        obj.dim = int(bf16.shape[1])
        obj._padded = int(bf16.shape[0])
        obj.dev_bf16, obj.dev_packed, obj.dev_scales = bf16, packed, scales
        host_mask = np.zeros(obj._padded, dtype=bool)
        if isinstance(mask, torch.Tensor):
            mask = mask.cpu().numpy()
        m = np.asarray(mask, dtype=bool)
        host_mask[: len(m)] = m[: obj._padded]
        obj._host_mask = host_mask
        obj.dev_mask = upload(host_mask, obj.device)
        obj.ids = ids
        obj._id_to_row = None
        return obj

    @classmethod
    def from_host_planes(cls, bf16_rows: np.ndarray,
                         packed_rows: np.ndarray,
                         scales_rows: np.ndarray,
                         mask: np.ndarray, n_rows: int,
                         ids: list[str] | None = None,
                         headroom: int = 0,
                         chunk: int = _CHUNK,
                         device: str | torch.device = "cuda"
                         ) -> "CapacitySearcher":
        """Build the view from ALREADY-QUANTISED host planes (a
        ``gallery/planes.py`` sidecar; ``bf16_rows`` as 16-bit patterns):
        2.5·N·D bytes uploaded chunk by chunk, no device quantisation.
        Inputs may be read-only memmaps. Rows padded as the f32
        constructor pads them, with a zero tail."""
        device = resolve_device(device)
        d = int(bf16_rows.shape[1])
        if packed_rows.shape != (n_rows, d // 2) or \
                scales_rows.shape[0] != n_rows or \
                bf16_rows.shape[0] != n_rows:
            raise ValueError("plane shapes disagree with n_rows/dim")
        chunk = max(256, (min(chunk, _CHUNK) // 256) * 256)
        padded = -(-(n_rows + max(0, headroom)) // chunk) * chunk
        bf16 = torch.zeros((padded, d), dtype=torch.bfloat16, device=device)
        packed = torch.zeros((padded, d // 2), dtype=torch.int8,
                             device=device)
        scales = torch.zeros(padded, dtype=torch.float32, device=device)
        for start in range(0, n_rows, chunk):
            hi = min(start + chunk, n_rows)
            bf16[start:hi] = _bf16_from_host(bf16_rows[start:hi], device)
            packed[start:hi] = upload(packed_rows[start:hi], device)
            scales[start:hi] = upload(scales_rows[start:hi], device)
        return cls.from_device_planes(bf16, packed, scales, mask,
                                      n_rows, ids=ids)

    @classmethod
    def from_gallery(cls, gallery, flt=None, chunk: int = _CHUNK,
                     headroom: int = 0) -> "CapacitySearcher":
        if gallery.distance != "cosine":
            raise ValueError("capacity mode quantises unit-norm rows — "
                             "cosine collections only")
        gallery.compact()  # dense live-row view (no-op if no tombstones)
        n = len(gallery)
        mask = (np.ones(n, bool) if flt is None
                else gallery._payloads.mask(flt))
        return cls(gallery._vectors[:n], mask, chunk=chunk,
                   ids=list(gallery._ids), headroom=headroom,
                   device=gallery.device)

    def ids_of(self, idx: np.ndarray) -> list:
        """Translate ``search`` row indices to point ids (needs a view
        built by ``from_gallery`` or with ``ids=``); rows past the id list
        map to None. Shape is kept as nested lists."""
        if self.ids is None:
            raise ValueError("this view was built from raw vectors — "
                             "construct with ids= or from_gallery for "
                             "id translation")
        n = len(self.ids)
        return [[self.ids[int(i)] if 0 <= int(i) < n else None
                 for i in row] for row in np.atleast_2d(idx)]

    # ------------------------------------------------------------ writes
    @property
    def _tile(self) -> int:
        # Fixed patch granularity that tiles the padded rows exactly; the
        # default chunking (multiples of 2^18) always admits _TILE, small
        # views fall back to 256-row tiles.
        return _TILE if self._padded % _TILE == 0 else 256

    def capacity_left(self) -> int:
        """Rows that can still be appended without a plane rebuild."""
        return self._padded - self.n_rows

    def upsert_rows(self, start: int, vectors: np.ndarray) -> None:
        """Overwrite/append rows [start, start+m) incrementally.

        Full tiles push straight from the new rows; partial edge tiles
        read back the bf16 tile, overlay, and re-pack. Appends must fit
        the build-time ``headroom``; beyond it, rebuild."""
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        m, d = vectors.shape
        if d != self.dim:
            raise ValueError(f"dim {d} != view dim {self.dim}")
        if start < 0 or start > self.n_rows:
            raise ValueError(
                f"start {start} outside [0, {self.n_rows}] — capacity "
                "writes are overwrites or contiguous appends")
        end = start + m
        if end > self._padded:
            raise ValueError(
                f"write to row {end} exceeds capacity {self._padded}; "
                "rebuild the view (or build with headroom=)")
        tile = self._tile
        for ts in range((start // tile) * tile, end, tile):
            te = ts + tile
            if ts >= start and te <= end:
                staged = vectors[ts - start: te - start]
            else:
                # Edge tile: read back (tile x D bf16), overlay the new
                # rows, re-push the whole tile.
                staged = self.dev_bf16[ts:te].to(torch.float32).cpu().numpy()
                lo, hi = max(start, ts), min(end, te)
                staged[lo - ts: hi - ts] = vectors[lo - start: hi - start]
            # ``staged`` may be a slice of the caller's live buffer:
            # upload copies.
            self._fill(upload(staged, self.device), ts)
        self.n_rows = max(self.n_rows, end)
        self._set_mask_range(start, end, True)

    def _push_mask_tile(self, ts: int) -> None:
        tile = self._tile
        self.dev_mask[ts: ts + tile] = upload(
            self._host_mask[ts: ts + tile], self.device)

    def _set_mask_range(self, lo: int, hi: int, value: bool) -> None:
        self._host_mask[lo:hi] = value
        tile = self._tile
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
        """Id-keyed insert-or-replace (Gallery.upsert semantics at
        capacity scale); scattered rows group into contiguous runs, one
        incremental patch each."""
        return id_keyed_upsert(self, ids, vectors, self._padded)

    def set_rows_invalid(self, rows) -> int:
        """Tombstone rows BY INDEX through the mask — the planes stay put.
        Each affected mask tile is pushed once for the whole batch."""
        live = [int(r) for r in rows
                if 0 <= int(r) < self.n_rows and self._host_mask[int(r)]]
        for r in live:
            self._host_mask[r] = False
        tile = self._tile
        for ts in sorted({(r // tile) * tile for r in live}):
            self._push_mask_tile(ts)
        return len(live)

    def delete(self, ids) -> int:
        """Tombstone rows by id through the mask (see set_rows_invalid)."""
        id_map = self._ensure_id_map()
        return self.set_rows_invalid(
            [id_map[pid] for pid in ids if pid in id_map])

    def search(self, queries: np.ndarray, k: int = 10,
               rescore: int = 256,
               extra_mask=None,
               ) -> tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k], row indices [Q, k]) as host arrays; rows outside
        the view's mask or ``extra_mask`` (a host bool array over the rows,
        or a device mask at the padded row count) score NEG_INF."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        # The final top-k ranks within the rescored candidates: a k beyond
        # them widens the set.
        rescore = min(max(rescore, k), self._padded)
        mask = self.dev_mask
        if extra_mask is not None:
            if (isinstance(extra_mask, torch.Tensor)
                    and extra_mask.shape[0] == self._padded):
                # Padded and on the device already (the Gallery caches
                # per-filter masks).
                mask = mask & extra_mask.to(self.device)
            else:
                # A host mask built before an append still covers the rows
                # it has; appended rows default to excluded.
                buf = np.zeros(self._padded, bool)
                m = np.asarray(extra_mask, bool)
                n = min(self.n_rows, m.shape[0])
                buf[:n] = m[:n]
                mask = mask & upload(buf, self.device)
        q = upload(queries, self.device)
        scores, idx = search_lib.int4_scan_topk(
            q, self.dev_packed, self.dev_scales, self.dev_bf16, mask,
            k=min(k, self.n_rows), rescore=rescore)
        return scores.cpu().numpy(), idx.cpu().numpy()


def id_keyed_upsert(view, ids, vectors: np.ndarray,
                    row_capacity: int) -> int:
    """Id-keyed insert-or-replace for a writable device view. Scattered
    rows group into contiguous runs (one incremental patch each); new ids
    append within ``row_capacity``. The capacity check runs before any
    id-map mutation, so an overflow leaves no phantom ids mapped to
    unwritten rows. ``view`` provides ``_ensure_id_map()``, ``n_rows``,
    ``ids``, ``capacity_left()`` and ``upsert_rows(start, vecs)``."""
    vectors = np.asarray(vectors, np.float32)
    if vectors.ndim == 1:
        vectors = vectors[None]
    if len(ids) != vectors.shape[0]:
        raise ValueError("ids/vectors length mismatch")
    id_map = view._ensure_id_map()
    n_new = len({pid for pid in ids if pid not in id_map})
    if view.n_rows + n_new > row_capacity:
        raise ValueError(
            f"{n_new} new ids exceed capacity "
            f"({view.capacity_left()} rows left of {row_capacity}); "
            "rebuild the view (or build with headroom=)")
    rows = np.empty(len(ids), np.int64)
    next_row = view.n_rows
    for i, pid in enumerate(ids):
        row = id_map.get(pid)
        if row is None:  # new id -> contiguous append slot
            row = next_row
            id_map[pid] = row
            view.ids.append(pid)
            next_row += 1
        rows[i] = row
    order = np.argsort(rows, kind="stable")
    rows_s, vecs_s = rows[order], vectors[order]
    run_start = 0
    for i in range(1, len(rows_s) + 1):
        if i == len(rows_s) or rows_s[i] != rows_s[i - 1] + 1:
            view.upsert_rows(int(rows_s[run_start]), vecs_s[run_start:i])
            run_start = i
    return len(ids)
