"""Capacity-plane sidecar: persist the int4 + bf16 serving planes.

The capacity tier's device planes (bf16 rescore mirror + packed int4 +
per-row scales — ``gallery/capacity.py``) are a deterministic function of
the snapshot rows. This module persists them as a ``<name>.rbod.planes``
sidecar next to the base snapshot, so a restart streams 2.5·N·D bytes
straight into the device planes instead of uploading 4·N·D bytes of f32
rows and quantising them again.

Validity is keyed on the snapshot identity: the header records the base
snapshot id and delta sequence the planes were computed at, and the store
uses the sidecar only when its live state matches exactly
(``Gallery._planes_sidecar_view``); any later write falls back to the
chunked device build. A full base rewrite unlinks the sidecar
(``persist.save_gallery``).

Plane bytes are computed on the host (``host_pack_planes``, the NumPy twin
of the device fill), so writing the sidecar is a CPU + disk pass over the
(possibly memmap-backed) host rows. The file is byte for byte the JAX
package's: the same header, sections and alignment. bf16 is formed without
``ml_dtypes`` (which the JAX package uses), by round-to-nearest-even on
the f32 bit pattern (``bf16_bits``), the rounding ``ml_dtypes`` and a
device cast both do; ``open_sections`` hands the bf16 section back as its
16-bit patterns.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import numpy as np

_MAGIC = b"RBP1"
_ALIGN = 8


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 → the uint16 bit patterns of bf16, rounded to nearest, ties to
    even (a NaN becomes the quiet NaN 0x7FC0)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rtne = (u + (((u >> 16) & 1) + np.uint32(0x7FFF))) >> 16
    return np.where(np.isnan(x), np.uint32(0x7FC0), rtne).astype(np.uint16)


def host_pack_planes(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """(bf16 bit patterns [m, D] uint16, packed int4 [m, D/2] int8,
    scales [m] f32) from raw f32 rows — the NumPy twin of the device fill
    (``CapacitySearcher._fill``: L2-normalise, bf16 cast) and
    ``search.pack_rows_int4`` (per-row scale ``max|x|/7``, biased low
    nibble ``b = 16*hi + lo + 8``). np.round is round-half-even, as the
    device's round is."""
    rows = np.asarray(rows, np.float32)
    m, d = rows.shape
    if d % 2:
        raise ValueError("int4 packing needs an even dim")
    norm = np.sqrt(np.einsum("nd,nd->n", rows, rows,
                             dtype=np.float32))[:, None]
    rows = rows / np.maximum(norm, np.float32(1e-12))
    bf16 = bf16_bits(rows)
    s = np.maximum(np.abs(rows).max(axis=1, keepdims=True),
                   np.float32(1e-12)) / np.float32(7.0)
    q = np.clip(np.round(rows / s), -8, 7).astype(np.int16)
    lo, hi = q[:, : d // 2], q[:, d // 2:]
    packed = (hi * 16 + lo + 8).astype(np.int8)
    return bf16, packed, s[:, 0].astype(np.float32)


def sidecar_path(root: str | Path, name: str) -> Path:
    return Path(root) / f"{name}.rbod.planes"


def write_planes(path: str | Path, vectors: np.ndarray, n: int, dim: int,
                 base_id: str, seq: int, chunk: int = 1 << 17) -> None:
    """Stream the planes of ``vectors[:n]`` into ``path`` (NOT atomic —
    callers write to a temp name and rename; persist.save_capacity_planes
    owns that protocol). The file is pre-sized and filled through
    memmapped sections, so peak RAM stays one chunk regardless of N."""
    path = Path(path)
    sizes = {"bf16": n * dim * 2, "packed": n * (dim // 2), "scales": n * 4}
    secmap, off = {}, 0
    for name in ("bf16", "packed", "scales"):
        secmap[name] = [off, sizes[name]]
        off = (off + sizes[name] + _ALIGN - 1) // _ALIGN * _ALIGN
    hdr = {"base_id": base_id, "seq": int(seq), "n": int(n),
           "dim": int(dim), "sections": secmap}
    js = json.dumps(hdr).encode()
    data_base = (8 + len(js) + _ALIGN - 1) // _ALIGN * _ALIGN
    total = data_base + off
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(js)))
        f.write(js)
        f.truncate(total)
    # bf16 is stored as its raw 16-bit patterns.
    mm_b = np.memmap(path, np.uint16, mode="r+",
                     offset=data_base + secmap["bf16"][0], shape=(n, dim))
    mm_p = np.memmap(path, np.int8, mode="r+",
                     offset=data_base + secmap["packed"][0],
                     shape=(n, dim // 2))
    mm_s = np.memmap(path, np.float32, mode="r+",
                     offset=data_base + secmap["scales"][0], shape=(n,))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        bf16, packed, scales = host_pack_planes(vectors[lo:hi])
        mm_b[lo:hi] = bf16
        mm_p[lo:hi] = packed
        mm_s[lo:hi] = scales
    mm_b.flush()
    mm_p.flush()
    mm_s.flush()
    del mm_b, mm_p, mm_s
    # Durability matches the snapshot writer (rbod_native.cc fsync): a
    # renamed-in sidecar must not be torn by power loss.
    fd = os.open(path, os.O_RDWR)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_header(path: str | Path) -> dict:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != _MAGIC:
            raise ValueError(f"not a planes sidecar: {path}")
        (jlen,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(jlen).decode())


def open_sections(path: str | Path) -> tuple[dict, np.ndarray, np.ndarray,
                                             np.ndarray]:
    """(header, bf16 bit patterns [n, D] uint16, packed [n, D/2],
    scales [n]) — read-only memmaps; pages fault in as the chunked upload
    walks them."""
    path = Path(path)
    hdr = read_header(path)
    n, dim = int(hdr["n"]), int(hdr["dim"])
    with open(path, "rb") as f:
        f.seek(4)
        (jlen,) = struct.unpack("<I", f.read(4))
    data_base = (8 + jlen + _ALIGN - 1) // _ALIGN * _ALIGN
    sec = hdr["sections"]
    mm_b = np.memmap(path, np.uint16, mode="r",
                     offset=data_base + sec["bf16"][0], shape=(n, dim))
    mm_p = np.memmap(path, np.int8, mode="r",
                     offset=data_base + sec["packed"][0],
                     shape=(n, dim // 2))
    mm_s = np.memmap(path, np.float32, mode="r",
                     offset=data_base + sec["scales"][0], shape=(n,))
    return hdr, mm_b, mm_p, mm_s
