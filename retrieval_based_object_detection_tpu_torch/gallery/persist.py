"""Snapshot persistence for the vector store.

Replaces the durability Qdrant got from its Docker volume
(02_qdrant_environment_setting.txt:2-7). Each collection snapshots to a
single ``<root>/<name>.rbod`` file — a flat binary format (header + metadata
blob + raw float32 vectors) written/read by the C++ runtime
(``native.snapshot_write``/``snapshot_read``; the NumPy fallback uses the
identical byte layout) — plus ``<name>.rbod.d<seq>`` deltas and an optional
``<name>.rbod.planes`` capacity sidecar. Writes are atomic
(temp-then-rename, fsync); legacy ``.npz``+``.json`` snapshots still load.

The port of the JAX package's ``gallery/persist.py``: the files are byte
for byte the same, and either package loads what the other wrote. Loaded
galleries live on ``device``. Unlike the reference, a delta save removes a
planes sidecar that the save has made stale, instead of leaving it on disk.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

import torch

from retrieval_based_object_detection_tpu_torch import native
from retrieval_based_object_detection_tpu_torch.gallery import planes as planes_lib
from retrieval_based_object_detection_tpu_torch.gallery.schema import PayloadColumns
from retrieval_based_object_detection_tpu_torch.gallery.store import Gallery, VectorStore


# A delta save is taken instead of a full rewrite while the changed
# fraction stays below this (past it, rewriting the base is cheaper than
# an ever-longer replay chain).
DELTA_MAX_CHURN_FRACTION = 0.25

# Base snapshots use the format-3 BINARY meta blob: a small JSON header
# (identity, decode tables, section offsets) followed by raw sections —
# fixed-width id table, int32 code columns, packbit bools, NUL-joined
# paths. Restart no longer JSON-parses millions of strings or builds the
# id/path dicts (lazy); with mmap the id/path bytes aren't even read
# until first use. Deltas (small row counts) keep the v2 JSON body.
_B3_MAGIC = b"RBM3"


def _pack_meta3(header: dict, sections: list[tuple[str, bytes]]) -> bytes:
    """MAGIC | u32 json_len | json | pad | 8-aligned sections. The
    json's ``sections`` map holds [offset, len] RELATIVE to the data
    region (which starts at the first 8-aligned byte after the json),
    so section offsets never depend on the json's own size."""
    import struct

    hdr = dict(header)
    secmap = {}
    off = 0
    for name, data in sections:
        secmap[name] = [off, len(data)]
        off = (off + len(data) + 7) // 8 * 8
    hdr["sections"] = secmap
    js = json.dumps(hdr).encode()
    out = bytearray()
    out += _B3_MAGIC
    out += struct.pack("<I", len(js))
    out += js
    data_base = (len(out) + 7) // 8 * 8
    for name, data in sections:
        start = data_base + secmap[name][0]
        out += b"\x00" * (start - len(out))
        out += data
    return bytes(out)


def _parse_meta3(blob) -> tuple[dict, "callable"]:
    """(header, get_section). ``blob`` is bytes (eager) or a memoryview
    over the snapshot mmap (sections stay unread until sliced)."""
    import struct

    (jlen,) = struct.unpack_from("<I", blob, 4)
    hdr = json.loads(bytes(blob[8:8 + jlen]).decode())
    data_base = (8 + jlen + 7) // 8 * 8

    def get(name):
        off, ln = hdr["sections"][name]
        return blob[data_base + off: data_base + off + ln]

    return hdr, get


def _fsync_dir(root: Path) -> None:
    """Persist a rename: the file's data blocks are fsynced by the
    writer (native/_snapshot_write_py, or the manifest's explicit
    fsync), but the DIRECTORY entry created by os.replace needs its own
    fsync or power loss can leave the old/absent name. Best-effort —
    some filesystems refuse O_RDONLY dir fsync."""
    try:
        fd = os.open(root, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _delta_paths(name: str, root: Path) -> list[tuple[int, Path]]:
    out = []
    for p in root.glob(f"{name}.rbod.d*"):
        try:
            out.append((int(p.name.rsplit(".d", 1)[1]), p))
        except ValueError:
            continue
    return sorted(out)


def _manifest_update_count(root: Path, name: str, count: int) -> None:
    """Refresh one collection's live count in manifest.json (atomic
    rewrite); no-op when no manifest exists yet — save_store creates it
    with the full name list, this only keeps counts fresh in between."""
    manifest = root / "manifest.json"
    if not manifest.exists():
        return
    try:
        with open(manifest) as f:
            data = json.load(f)
    except Exception:
        return  # corrupt manifest: the next save_store rewrites it
    counts = data.get("counts") or {}
    if counts.get(name) == count:
        return
    counts[name] = count
    data["counts"] = counts
    tmp = root / ".manifest.json.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, manifest)


def save_gallery(gallery: Gallery, root: str | Path,
                 incremental: bool = True) -> None:
    """Snapshot one collection.

    ``incremental=True`` (default): when a base snapshot from THIS
    gallery already exists in ``root`` and the churn since the last save
    is under DELTA_MAX_CHURN_FRACTION, only the changed points are
    appended as a ``<name>.rbod.d<seq>`` delta (same binary container) —
    a 1-row change on a 1M-row collection costs milliseconds, not a
    2 GB whole-world rewrite. A clean gallery is a no-op. Deltas replay in sequence on load; past the churn threshold
    (or on any root/identity mismatch) the base is rewritten and the
    chain collapses."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    base = root / f"{gallery.name}.rbod"
    dirty = {pid for pid in gallery._snap_dirty
             if pid in gallery._id_to_row}
    deleted = set(gallery._snap_deleted)
    can_delta = (incremental and gallery._snap_id is not None
                 and gallery._snap_root == str(root) and base.exists())
    if can_delta and not dirty and not deleted:
        return  # nothing changed since the last snapshot
    if can_delta and (len(dirty) + len(deleted)
                      <= DELTA_MAX_CHURN_FRACTION * max(len(gallery), 4)):
        seq = gallery._snap_seq + 1
        ids = sorted(dirty)
        rows = np.asarray([gallery._id_to_row[pid] for pid in ids],
                          np.int64)
        meta = {
            "format": 2,
            "delta": True,
            "base_id": gallery._snap_id,
            "seq": seq,
            "name": gallery.name,
            "dim": gallery.dim,
            "distance": gallery.distance,
            "ids": ids,
            "deleted": sorted(deleted),
            "columns": gallery._payloads.export_rows(rows),
        }
        if gallery._snap_rows_valid:
            # Row-indexed ops: live row numbering still matches the base
            # (no compaction since it was written), so the replay can
            # write rows directly on a lazily loaded gallery — no id-map
            # or path-index materialisation. A compaction clears the flag
            # and the replay falls back to the id-keyed path.
            meta["rows"] = [int(r) for r in rows]
            meta["dead_rows"] = sorted(gallery._snap_dead_rows)
        vecs = (gallery._vectors[rows] if len(rows)
                else np.zeros((0, gallery.dim), np.float32))
        tmp = root / f".{gallery.name}.rbod.d{seq}.tmp"
        native.snapshot_write(tmp, vecs, json.dumps(meta).encode())
        os.replace(tmp, root / f"{gallery.name}.rbod.d{seq}")
        _fsync_dir(root)
        gallery._snap_seq = seq
        gallery._snap_dirty.clear()
        gallery._snap_deleted.clear()
        gallery._snap_dead_rows.clear()
        # A delta leaves the base header's row count stale; header-only
        # listings read the live count from the manifest, so a DIRECT
        # save_gallery (not via save_store, which rewrites the manifest
        # wholesale) refreshes its own entry.
        _manifest_update_count(root, gallery.name, len(gallery))
        # The delta moved the snapshot identity past any planes sidecar
        # (keyed on base id + seq): it can never serve again, so remove
        # it rather than leave gigabytes on disk.
        _drop_sidecar(gallery, root)
        return

    # Full base rewrite (also collapses any existing delta chain).
    gallery.compact()  # snapshots are dense live-row views (no-op if clean)
    n = len(gallery)
    import uuid

    snap_id = uuid.uuid4().hex
    # Format 3: binary meta — small JSON header + raw id table/column
    # sections (see _pack_meta3). Loads slice the sections zero-copy and
    # defer the id/path dict builds; measured restart at 1M went from
    # JSON-parse-bound seconds to header-read milliseconds.
    ids_b = [s.encode("utf-8") for s in gallery._ids]
    id_width = max((len(b) for b in ids_b), default=1) or 1
    ids_arr = np.array(ids_b, dtype=f"S{id_width}") if ids_b else \
        np.zeros(0, dtype=f"S{id_width}")
    col_hdr, sections = gallery._payloads.export_binary(n)
    meta = {
        "format": 3,
        "snapshot_id": snap_id,
        "name": gallery.name,
        "dim": gallery.dim,
        "distance": gallery.distance,
        "n": n,
        "id_width": id_width,
        "decode": col_hdr["decode"],
    }
    blob = _pack_meta3(meta, [("ids", ids_arr.tobytes())] + sections)
    tmp = root / f".{gallery.name}.rbod.tmp"
    native.snapshot_write(tmp, gallery._vectors[:n], blob)
    os.replace(tmp, base)
    _fsync_dir(root)
    for _, p in _delta_paths(gallery.name, root):
        p.unlink(missing_ok=True)
    # A new base invalidates any capacity-plane sidecar (its header is
    # keyed on the OLD snapshot id). Regenerate with save_capacity_planes
    # after bulk saves.
    _drop_sidecar(gallery, root)
    gallery._snap_root = str(root)
    gallery._snap_id = snap_id
    gallery._snap_seq = 0
    gallery._snap_dirty.clear()
    gallery._snap_deleted.clear()
    gallery._snap_dead_rows.clear()
    gallery._snap_rows_valid = True  # fresh base: live rows == base rows


def _drop_sidecar(gallery: Gallery, root: Path) -> None:
    sidecar = planes_lib.sidecar_path(root, gallery.name)
    sidecar.unlink(missing_ok=True)
    if gallery._planes_path == str(sidecar):
        gallery._planes_path = None


def load_gallery(name: str, root: str | Path,
                 mmap_vectors: bool = False,
                 device: str | torch.device = "cuda") -> Gallery:
    """Load one collection. ``mmap_vectors=True`` maps the vector block
    copy-on-write instead of reading it upfront: the load returns in
    milliseconds whatever the size and pages fault in on first use (the
    first mirror build, a scroll with vectors, the next save); upserts
    write private COW pages, so semantics are identical to an eager
    load. The gallery searches on ``device``."""
    root = Path(root)
    rbod = root / f"{name}.rbod"
    if rbod.exists() and mmap_vectors:
        rows, dim, pb = native.snapshot_header(rbod)
        vectors = np.memmap(rbod, dtype=np.float32, mode="c",
                            offset=32 + pb, shape=(rows, dim))
        with open(rbod, "rb") as f:
            f.seek(32)
            magic = f.read(4)
            if magic == _B3_MAGIC:
                # Format 3 + mmap: map the META region too — the id
                # table and path bytes are sliced as memoryviews and
                # only PAGE IN when first touched (the load itself
                # reads the small JSON header + the code/bool columns).
                import mmap as _mmap

                f.seek(0)
                mm = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
                blob = memoryview(mm)[32:32 + pb]
                hdr, get = _parse_meta3(blob)
                g = _gallery_from_binary(name, hdr, get, vectors, device)
                return _apply_deltas(g, hdr.get("snapshot_id"), root)
            f.seek(32)
            meta = json.loads(f.read(pb).decode())
    elif rbod.exists():
        vectors, blob = native.snapshot_read(rbod)
        if blob[:4] == _B3_MAGIC:
            hdr, get = _parse_meta3(blob)
            g = _gallery_from_binary(name, hdr, get, vectors, device)
            return _apply_deltas(g, hdr.get("snapshot_id"), root)
        meta = json.loads(blob.decode())
    else:  # legacy npz+json layout
        with open(root / f"{name}.json") as f:
            meta = json.load(f)
        with np.load(root / f"{name}.npz") as z:
            vectors = z["vectors"]
    if meta.get("format", 1) >= 2:
        g = _gallery_from_columns(name, meta, vectors, device)
        return _apply_deltas(g, meta.get("snapshot_id"), root)
    return Gallery.from_arrays(  # format 1 (round-1 snapshots) still loads
        name,
        {
            "ids": meta["ids"],
            "vectors": vectors,
            "payloads": meta["payloads"],
            "dim": meta["dim"],
            "distance": meta.get("distance", "cosine"),
        },
        device=device,
    )


def _apply_deltas(g: Gallery, snap_id: str | None,
                  root: Path) -> Gallery:
    """Replay ``<name>.rbod.d<seq>`` delta files over the base, in
    sequence. A gap or base-identity mismatch stops the replay with a
    warning (stale deltas from an older base are ignored, never mixed
    in). On success the gallery continues the delta chain on its next
    incremental save."""
    deltas = _delta_paths(g.name, root)
    expected = 1
    applied = 0
    broken = False
    chain_fast = True  # flips off permanently after any id-keyed replay
    for seq, path in deltas:
        try:
            vectors, blob = native.snapshot_read(path)
            meta = json.loads(blob.decode())
        except OSError as e:
            # TRANSIENT read error (EIO, permissions): the file on disk
            # may be intact, so never unlink it — poison the chain
            # instead (snap_id=None) so the next save rewrites the base
            # and collapses the chain; until then loads serve the data
            # applied so far.
            import sys

            print(f"[gallery] WARNING: IO error reading delta "
                  f"{path.name}: {e} — chain poisoned, next save "
                  f"rewrites the base", file=sys.stderr)
            snap_id = None
            break
        except Exception as e:
            # Format/identity corruption: the bytes themselves are bad —
            # the tail beyond this link is unrecoverable by design and
            # is pruned below so later saves cannot reuse its sequence
            # numbers.
            import sys

            print(f"[gallery] WARNING: skipping unreadable delta "
                  f"{path.name}: {e}", file=sys.stderr)
            broken = True
            break
        if (not meta.get("delta") or meta.get("base_id") != snap_id
                or seq != expected):
            if meta.get("base_id") != snap_id:
                continue  # stale delta of an older base: ignore
            import sys

            print(f"[gallery] WARNING: delta chain gap at {path.name} "
                  f"(expected seq {expected}) — later deltas ignored",
                  file=sys.stderr)
            broken = True
            break
        ids = meta["ids"]
        fast = False
        if chain_fast and meta.get("rows") is not None:
            try:
                _replay_delta_fast(g, meta, vectors)
                fast = True
            except _FastReplayInvalid:
                fast = False
        if not fast:
            # Id-keyed replay (pre-row-format deltas, or any fast-path
            # precondition violated). Once one delta replays by id the
            # rest of the chain must too: the id-keyed path can lay a
            # re-added point out on a different row than the live
            # gallery did, so later ROW-indexed deltas would no longer
            # line up.
            chain_fast = False
            if ids:
                cols = PayloadColumns.import_columns(meta["columns"],
                                                     len(ids))
                g.upsert(ids, vectors[: len(ids)],
                         cols.get_rows(np.arange(len(ids))))
            if meta.get("deleted"):
                g.delete(ids=meta["deleted"])
        expected = seq + 1
        applied = seq
    if broken:
        # Remove the unusable tail NOW: leaving same-base deltas with
        # seq > applied on disk lets a LATER save reuse those sequence
        # numbers, and the next load would replay the stale files over
        # newer data. The tail is beyond a broken link, so it is
        # unrecoverable by design.
        for seq, path in deltas:
            if seq > applied:
                try:
                    path.unlink(missing_ok=True)
                except OSError:
                    # Read-only root: poison the chain instead so the
                    # next save rewrites the base and collapses it.
                    snap_id = None
                    break
    # Continue the chain from the last applied delta on future saves.
    g._snap_root = str(root)
    g._snap_id = snap_id
    g._snap_seq = applied
    g._snap_dirty.clear()
    g._snap_deleted.clear()
    g._snap_dead_rows.clear()
    sidecar = planes_lib.sidecar_path(root, g.name)
    if sidecar.exists():
        # Record the capacity-plane sidecar; the store validates its
        # snapshot identity lazily at view-build time (a mismatched or
        # torn sidecar degrades to the chunked device build).
        g._planes_path = str(sidecar)
    return g


def save_capacity_planes(gallery: Gallery, root: str | Path) -> Path:
    """Persist the capacity tier's serving planes (bf16 mirror + packed
    int4 + scales) as a ``<name>.rbod.planes`` sidecar next to the base
    snapshot, so the NEXT restart's first capacity search streams
    pre-quantised planes to the device instead of re-deriving them from
    f32 rows (at 10M×512, 13.4 GB uploaded instead of 21.5 GB plus a
    device quantise pass). Pure host-side CPU+disk work
    (gallery/planes.py), safe to run after ``save_gallery``/``save_store``
    on a live server.

    Requires a saved, churn-free gallery (the sidecar is keyed on the
    snapshot identity: base id + delta seq) — call immediately after a
    save. Atomic (temp-then-rename + fsync), like the snapshots."""
    root = Path(root)
    if gallery._snap_id is None or gallery._snap_root != str(root):
        raise ValueError(
            "save_capacity_planes needs a gallery saved to this root "
            "(the sidecar is keyed on the base snapshot id) — call "
            "save_gallery/save_store first")
    if gallery._snap_dirty or gallery._snap_deleted \
            or gallery._snap_dead_rows:
        raise ValueError(
            "gallery has unsaved churn — save_gallery first so the "
            "sidecar matches a durable snapshot state")
    if not gallery._snap_rows_valid:
        raise ValueError(
            "live row numbering no longer matches the base snapshot "
            "(compaction since the save) — rewrite the base first "
            "(save_gallery(incremental=False))")
    if gallery.distance != "cosine" or gallery.dim % 2:
        raise ValueError("capacity planes serve cosine, even-dim "
                         "collections only")
    final = planes_lib.sidecar_path(root, gallery.name)
    tmp = root / f".{gallery.name}.rbod.planes.tmp"
    n = gallery._nrows
    planes_lib.write_planes(tmp, gallery._vectors, n, gallery.dim,
                            gallery._snap_id, gallery._snap_seq)
    os.replace(tmp, final)
    _fsync_dir(root)
    gallery._planes_path = str(final)
    return final


class _FastReplayInvalid(Exception):
    """A row-indexed delta's preconditions do not hold against this
    gallery — the caller falls back to the id-keyed replay."""


def _replay_delta_fast(g: Gallery, meta: dict, vectors: np.ndarray) -> None:
    """Apply one ROW-indexed delta without materialising the lazily
    loaded id map / id list / path index.

    The writer records each dirty id's live row plus every row
    tombstoned since the last save (save_gallery), valid because row
    numbering is frozen between base snapshots (deletes tombstone in
    place; compaction invalidates the flag and downgrades the chain to
    id-keyed deltas). Overwrites patch buffers directly; appends extend
    the raw fixed-width id table; deletes flip the alive mask — so a
    one-row delta on a 10M-row base replays in microseconds instead of
    forcing the id/path materialisation.
    """
    ids = meta["ids"]
    rows = np.asarray(meta["rows"], np.int64)
    dead = np.asarray(sorted(int(r) for r in meta.get("dead_rows", ())),
                      np.int64)
    nphys = g._nrows
    # ---- validate everything BEFORE touching the gallery -------------
    if len(rows) != len(ids):
        raise _FastReplayInvalid("rows/ids length mismatch")
    if len(dead) and (dead[0] < 0 or dead[-1] >= nphys):
        raise _FastReplayInvalid("dead row out of range")
    if meta.get("deleted") and not len(dead):
        # Ids were deleted but their rows were not recorded — replaying
        # only the upserts would resurrect them.
        raise _FastReplayInvalid("deleted ids without dead_rows")
    if len(rows):
        if rows.min() < 0 or len(np.unique(rows)) != len(rows):
            raise _FastReplayInvalid("invalid/duplicate rows")
        if np.intersect1d(rows, dead).size:
            raise _FastReplayInvalid("row both written and dead")
        app = np.sort(rows[rows >= nphys])
        if len(app) and not np.array_equal(
                app, np.arange(nphys, nphys + len(app))):
            raise _FastReplayInvalid("append rows not contiguous")
    if any(h.view is not None for h in g._views) \
            or g._resolved_paths is not None:
        # Derived views never exist during a load; if one does, take the
        # id-keyed path that maintains them.
        raise _FastReplayInvalid("derived views live")

    # ---- deletes: tombstone rows in place ----------------------------
    for r in dead:
        r = int(r)
        if not g._alive[r]:
            continue
        g._alive[r] = False
        g._n_dead += 1
        g._payloads.clear_path(r)  # lazy-safe (pending overlay)
        if g._id_map is not None:
            pid = g._ids[r]
            if g._id_map.get(pid) == r:
                del g._id_map[pid]
    if (len(dead)
            and g._n_dead >= g._COMPACT_DEAD_MIN
            and g._n_dead >= g._COMPACT_DEAD_FRACTION * nphys):
        # Re-arm deferred compaction like the id-keyed path would (it
        # routes through g.delete): a maintain() window scheduled after
        # a restart must still reclaim tombstone space accrued before
        # it. Never compact inline here — the restart stays fast.
        g._compact_due = True

    # ---- upserts: direct row writes ----------------------------------
    if len(rows):
        k_new = int((rows >= nphys).sum())
        if k_new:
            g._ensure_capacity(k_new)
            order = np.argsort(rows, kind="stable")
            appends = [(int(rows[i]), ids[i]) for i in order
                       if rows[i] >= nphys]
            if g._ids_list is not None:
                for r, pid in appends:
                    g._ids_list.append(pid)
                    if g._id_map is not None:
                        g._id_map[pid] = r
            else:
                new_b = [pid.encode("utf-8") for _, pid in appends]
                w = max(g._ids_arr.dtype.itemsize,
                        max(len(b) for b in new_b))
                tail = np.array(new_b, dtype=f"S{w}")
                base = (g._ids_arr if w == g._ids_arr.dtype.itemsize
                        else g._ids_arr.astype(f"S{w}"))
                g._ids_arr = np.concatenate([base, tail])
        cols = PayloadColumns.import_columns(meta["columns"], len(ids))
        pls = cols.get_rows(np.arange(len(ids)))
        g._vectors[rows] = vectors[: len(ids)]
        g._payloads.set_rows(rows, pls)  # lazy-safe (pending overlay)
    g._masks.clear()
    g._wseq += 1


def _adopt_vectors(g: Gallery, vectors: np.ndarray, n: int,
                   dim: int) -> None:
    """Build the Gallery around the snapshot's own (writable) vector
    buffer instead of a fresh allocation + full copy — at 1M×512 that
    saves a transient 2 GB allocation and memcpy. COW memmaps qualify."""
    if n >= 1024 and vectors.shape == (n, dim) and vectors.flags.writeable:
        if not (vectors.dtype == np.float32
                and vectors.flags.c_contiguous):
            vectors = np.ascontiguousarray(vectors, np.float32)
        g._vectors = vectors  # adopted as-is (possibly a COW memmap)
        g._capacity = n
    else:  # small gallery (or legacy path): keep headroom, copy in
        g._capacity = max(1024, n)
        g._vectors = np.zeros((g._capacity, dim), np.float32)
        g._vectors[:n] = vectors[:n]
    # The ctor allocated for capacity=1; the adopted buffer needs a
    # matching tombstone mask (delta replay may delete immediately).
    g._alive = np.ones(g._capacity, dtype=bool)


def _gallery_from_binary(name: str, hdr: dict, get_section,
                         vectors: np.ndarray,
                         device: str | torch.device) -> Gallery:
    """Format-3 reconstruction: zero string parsing, LAZY ids/id-map/
    path-index (store.Gallery properties + PayloadColumns._ensure_paths
    materialise on first use). The load itself touches only the JSON
    header and the int32/bool column bytes."""
    n = int(hdr["n"])
    dim = int(hdr["dim"])
    g = Gallery(name, dim=dim, capacity=1,
                distance=hdr.get("distance", "cosine"), device=device)
    _adopt_vectors(g, vectors, n, dim)
    g._ids_arr = np.frombuffer(get_section("ids"),
                               dtype=f"S{int(hdr['id_width'])}", count=n)
    g._ids_list = None  # lazy list
    g._id_map = None    # lazy dict
    cols = PayloadColumns.import_binary(hdr, get_section, n)
    cols.grow(g._capacity)  # no-op when capacities already match
    g._payloads = cols
    return g


def _gallery_from_columns(name: str, meta: dict,
                          vectors: np.ndarray,
                          device: str | torch.device) -> Gallery:
    """Direct columnar reconstruction — no per-row Payload objects."""
    ids = meta["ids"]
    n = len(ids)
    dim = int(meta["dim"])
    g = Gallery(name, dim=dim, capacity=1,
                distance=meta.get("distance", "cosine"), device=device)
    _adopt_vectors(g, vectors, n, dim)
    g._ids = list(ids)
    g._id_map = None  # lazy dict build (~0.4 s/1M ids when eager)
    cols = PayloadColumns.import_columns(meta["columns"], n)
    cols.grow(g._capacity)  # no-op when capacities already match
    g._payloads = cols
    return g


def save_store(store: VectorStore, root: str | Path,
               incremental: bool = True) -> None:
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    names = [n for n, _ in store.list_collections()]
    for name in names:
        save_gallery(store.get(name), root, incremental=incremental)
    # Remove ONLY explicitly deleted/renamed snapshots. Snapshots that
    # merely failed to load (and were skipped with a warning) must
    # survive unrelated saves, so the manifest keeps them too.
    for dead in store._tombstones:
        snap = root / f"{dead}.rbod"
        if snap.exists():
            snap.unlink()
        for _, p in _delta_paths(dead, root):
            p.unlink(missing_ok=True)
        planes_lib.sidecar_path(root, dead).unlink(missing_ok=True)
    store._tombstones.clear()
    manifest_names = sorted(
        set(names) | {p.stem for p in root.glob("*.rbod")})
    tmp = root / ".manifest.json.tmp"
    with open(tmp, "w") as f:
        # Live counts per saved collection: a delta save leaves the
        # base header's row count stale (the delta carries the churn),
        # so header-only listings (list_snapshots, the wizard menu,
        # `rbod store count`) read the count from here instead of
        # replaying the chain.
        json.dump({"collections": manifest_names,
                   "counts": {n: len(store.get(n)) for n in names}}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, root / "manifest.json")
    _fsync_dir(root)


def load_store(root: str | Path,
               mmap_vectors: bool = False,
               device: str | torch.device = "cuda") -> VectorStore:
    root = Path(root)
    store = VectorStore(device=device)
    manifest = root / "manifest.json"
    if not manifest.exists():
        return store
    with open(manifest) as f:
        names = json.load(f)["collections"]
    for name in names:
        try:
            store._collections[name] = load_gallery(
                name, root, mmap_vectors=mmap_vectors, device=store.device)
        except Exception as e:  # corrupt header/JSON/meta too
            # A manifest entry without its snapshot (crash between writes,
            # manual deletion): skip it rather than refuse the whole store.
            import sys

            print(f"[gallery] WARNING: skipping collection {name!r}: {e}",
                  file=sys.stderr)
    return store


def list_snapshots(root: str | Path) -> list[tuple[str, int]]:
    """[(collection_name, point_count)] from snapshot headers only —
    O(1) per collection, no vector/payload deserialisation (the wizard's
    collection-pick menu must not pay a full store load)."""
    root = Path(root)
    out = []
    if not root.is_dir():
        return out
    counts: dict = {}
    try:
        with open(root / "manifest.json") as f:
            counts = json.load(f).get("counts") or {}
    except Exception:
        pass  # legacy/absent manifest: header rows only
    for p in sorted(root.glob("*.rbod")):
        try:
            name = p.stem
            if name in counts and _delta_paths(name, root):
                # Deltas pending: the base header's row count predates
                # them — the manifest carries the live count as of the
                # last save_store.
                out.append((name, int(counts[name])))
                continue
            rows, _, _ = native.snapshot_header(p)
            out.append((name, rows))
        except Exception:
            # One corrupt/truncated file (OSError from the native lib,
            # struct.error from the pure-Python fallback) must not hide
            # every healthy snapshot from the listing.
            continue
    for p in sorted(root.glob("*.json")):  # legacy layout
        if p.name == "manifest.json" or (root / f"{p.stem}.rbod").exists():
            continue
        try:
            import numpy as _np

            with _np.load(root / f"{p.stem}.npz") as z:
                out.append((p.stem, int(z["vectors"].shape[0])))
        except Exception:
            continue
    return sorted(out)
