"""ctypes bindings for the C++ host runtime (``rbod_native.cc``).

The filter kernel and the ``.rbod`` snapshot reader/writer. The shared
library is built at first use with ``g++`` into ``build/native/`` at the
root of the checkout (a directory git ignores), under a name that carries a
hash of the source, so an edited source is never served by a stale build;
nothing is compiled when the module is imported. Every entry point has a
pure-NumPy fallback with the identical byte format, so the package works
without a compiler; ``available()`` reports which path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np


class SnapshotFormatError(ValueError):
    """The snapshot BYTES are bad (magic/version mismatch, torn write).

    Distinct from OSError (environmental: cannot open, EIO) so callers
    can tell unrecoverable corruption from a transient read failure: the
    delta replay prunes the former but never unlinks files on the
    latter."""


_SRC = Path(__file__).resolve().parent / "rbod_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False


def library_path() -> Path:
    """Where the library for the current source and flags is built."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"librbod_native-{h.hexdigest()[:12]}.so"


def _build(lib: Path) -> bool:
    """Compile into a temporary name, then rename: a concurrent loader
    never sees a half-written library."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        pp_i32 = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
        pp_u8 = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
        lib.filter_mask.argtypes = [
            pp_i32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            pp_u8, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
        lib.filter_mask.restype = None
        lib.filter_count.argtypes = lib.filter_mask.argtypes[:-1]
        lib.filter_count.restype = ctypes.c_int64
        lib.snapshot_write.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.snapshot_write.restype = ctypes.c_int
        lib.snapshot_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        lib.snapshot_header.restype = ctypes.c_int
        lib.snapshot_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.snapshot_read.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True when the C++ library built and loaded (else NumPy serves)."""
    return _load() is not None


# ------------------------------------------------------------ filters
def filter_mask(
    int_cols: list[np.ndarray], int_vals: list[int],
    bool_cols: list[np.ndarray], bool_vals: list[bool],
    n: int,
) -> np.ndarray:
    """One-pass conjunctive equality filter → bool mask of length n."""
    lib = _load()
    if lib is None:
        return _filter_mask_numpy(int_cols, int_vals, bool_cols, bool_vals, n)
    int_cols = [np.ascontiguousarray(c[:n], np.int32) for c in int_cols]
    bool_cols = [np.ascontiguousarray(c[:n], np.uint8) for c in bool_cols]
    out = np.empty(n, np.uint8)
    ic = (ctypes.POINTER(ctypes.c_int32) * max(1, len(int_cols)))(
        *[c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
          for c in int_cols] or [ctypes.POINTER(ctypes.c_int32)()])
    iv = np.asarray(int_vals or [0], np.int32)
    bc = (ctypes.POINTER(ctypes.c_uint8) * max(1, len(bool_cols)))(
        *[c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
          for c in bool_cols] or [ctypes.POINTER(ctypes.c_uint8)()])
    bv = np.asarray([1 if v else 0 for v in bool_vals] or [0], np.uint8)
    lib.filter_mask(
        ic, iv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(int_cols),
        bc, bv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(bool_cols),
        n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def _filter_mask_numpy(int_cols, int_vals, bool_cols, bool_vals, n):
    m = np.ones(n, bool)
    for col, val in zip(int_cols, int_vals):
        m &= col[:n] == val
    for col, val in zip(bool_cols, bool_vals):
        m &= col[:n].astype(bool) == bool(val)
    return m


# ------------------------------------------------------------ snapshots
def snapshot_write(path: str | Path, vectors: np.ndarray,
                   payload_blob: bytes) -> None:
    vectors = np.ascontiguousarray(vectors, np.float32)
    rows, dim = vectors.shape
    lib = _load()
    if lib is None:
        _snapshot_write_py(path, vectors, payload_blob)
        return
    blob = np.frombuffer(payload_blob, np.uint8) if payload_blob else \
        np.empty(0, np.uint8)
    rc = lib.snapshot_write(
        str(path).encode(), vectors.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)),
        rows, dim,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(blob))
    if rc != 0:
        raise OSError(f"snapshot_write failed rc={rc}: {path}")


def snapshot_header(path: str | Path) -> tuple[int, int, int]:
    """(rows, dim, payload_blob_len) from a snapshot's fixed header —
    O(1), no vector/payload read (cheap collection listings)."""
    lib = _load()
    if lib is None:
        with open(path, "rb") as f:
            hdr = f.read(_HEADER.size)
        if len(hdr) < _HEADER.size:
            raise SnapshotFormatError(f"truncated snapshot header: {path}")
        magic, version, rows, dim, pb = _HEADER.unpack(hdr)
        if magic != _MAGIC or version != _VERSION:
            raise SnapshotFormatError(f"bad snapshot header: {path}")
        return rows, dim, pb
    rows = ctypes.c_int64()
    dim = ctypes.c_int64()
    pb = ctypes.c_int64()
    rc = lib.snapshot_header(str(path).encode(), ctypes.byref(rows),
                             ctypes.byref(dim), ctypes.byref(pb))
    if rc == 2:  # bad magic/version/short header: the bytes are bad
        raise SnapshotFormatError(f"bad snapshot header: {path}")
    if rc != 0:  # rc=1: open failed (missing file, permissions, EIO)
        raise OSError(f"cannot open snapshot rc={rc}: {path}")
    return rows.value, dim.value, pb.value


def snapshot_read(path: str | Path) -> tuple[np.ndarray, bytes]:
    lib = _load()
    if lib is None:
        return _snapshot_read_py(path)
    rows = ctypes.c_int64()
    dim = ctypes.c_int64()
    pb = ctypes.c_int64()
    rc = lib.snapshot_header(str(path).encode(), ctypes.byref(rows),
                             ctypes.byref(dim), ctypes.byref(pb))
    if rc == 2:
        raise SnapshotFormatError(f"bad snapshot header: {path}")
    if rc != 0:
        raise OSError(f"cannot open snapshot rc={rc}: {path}")
    vectors = np.empty((rows.value, dim.value), np.float32)
    blob = np.empty(pb.value, np.uint8)
    rc = lib.snapshot_read(
        str(path).encode(),
        vectors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.value, dim.value,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), pb.value)
    if rc == 4:
        # Short read: the file is shorter than its header promises — a
        # torn write. The BYTES are bad; persist._apply_deltas prunes
        # such deltas. Must match the NumPy fallback's classification.
        raise SnapshotFormatError(f"truncated snapshot body: {path}")
    if rc != 0:  # rc=1 open failed, rc=2 seek failed, rc=3 read errno
        raise OSError(f"snapshot_read failed rc={rc}: {path}")
    return vectors, blob.tobytes()


# Pure-Python fallbacks use the identical byte format.
import struct

_HEADER = struct.Struct("<IIQQQ")
_MAGIC = 0x444F4252
_VERSION = 1


def _snapshot_write_py(path, vectors, payload_blob):
    import os

    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, vectors.shape[0],
                             vectors.shape[1], len(payload_blob)))
        f.write(payload_blob)
        f.write(vectors.tobytes())
        f.flush()
        os.fsync(f.fileno())  # durability parity with the native writer


def _snapshot_read_py(path):
    with open(path, "rb") as f:
        hdr = f.read(_HEADER.size)
        if len(hdr) < _HEADER.size:
            raise SnapshotFormatError(f"truncated snapshot header: {path}")
        magic, version, rows, dim, pb = _HEADER.unpack(hdr)
        if magic != _MAGIC or version != _VERSION:
            raise SnapshotFormatError(f"bad snapshot header: {path}")
        blob = f.read(pb)
        vec_bytes = f.read(rows * dim * 4)
        if len(blob) < pb or len(vec_bytes) < rows * dim * 4:
            # Torn write: bad BYTES (prune), not a transient IO error —
            # same taxonomy as the native path's rc=4.
            raise SnapshotFormatError(f"truncated snapshot body: {path}")
        vectors = np.frombuffer(vec_bytes, np.float32
                                ).reshape(rows, dim).copy()
    return vectors, blob
