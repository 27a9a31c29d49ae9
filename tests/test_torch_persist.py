"""Port parity: ``.rbod`` persistence, the native runtime, memmap vectors
and lazy ids.

The same numpy-seeded galleries, with the same writes and deletes, are
saved by the JAX package and by the port. With the snapshot id pinned (it
is a random uuid), the base snapshot, its deltas and the planes sidecar are
the same bytes from both, and each package loads what the other wrote into
the same state (ids, payloads, vectors, tombstones, search hits). Oracles:
tests/test_persist_binary.py, test_persist_properties.py,
test_lazy_equivalence.py, test_native.py.
"""

import json
import os
import uuid

import numpy as np
import pytest

from retrieval_based_object_detection_tpu import native as jnative
from retrieval_based_object_detection_tpu.gallery import persist as jpersist
from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery.store import (
    Gallery as JGallery,
    VectorStore as JStore,
)
from retrieval_based_object_detection_tpu_torch import native as tnative
from retrieval_based_object_detection_tpu_torch.gallery import persist as tpersist
from retrieval_based_object_detection_tpu_torch.gallery import planes as tplanes
from retrieval_based_object_detection_tpu_torch.gallery import schema as tschema
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
)

DIM = 16
JAX = (jschema, jpersist, lambda n, **kw: JGallery(n, dim=DIM, **kw))
PORT = (tschema, tpersist,
        lambda n, **kw: TGallery(n, dim=DIM, device="cpu", **kw))


@pytest.fixture
def fixed_uuid(monkeypatch):
    """Both packages name a base snapshot by uuid4: pin it so the two
    writers can be compared byte for byte."""
    fixed = uuid.UUID(int=0x5EED)
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)


def _payloads(mod, lo, n, cls="c"):
    return [mod.Payload(data_type="original_images", class_name=f"{cls}{i % 3}",
                        img_path=f"/img/{i}.png", is_segmented=bool(i % 2))
            for i in range(lo, lo + n)]


def _build(pkg, n=1500, seed=0):
    mod, _, make = pkg
    g = make("snap")
    v = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    g.upsert([f"p{i:05d}" for i in range(n)], v, _payloads(mod, 0, n))
    return g


def _churn(pkg, g, seed=1):
    """Overwrite, append, delete, delete-then-re-add."""
    mod = pkg[0]
    v = np.random.default_rng(seed).normal(size=(4, DIM)).astype(np.float32)
    g.upsert(["p00017"], v[:1], _payloads(mod, 17, 1, "over"))
    g.upsert(["appended"], v[1:2], _payloads(mod, 9000, 1, "app"))
    g.delete(ids=["p00099", "p00042"])
    g.delete(flt=mod.Filter(must={"class_name": "c2",
                                  "is_segmented": False}))
    g.upsert(["p00042"], v[2:3], _payloads(mod, 42, 1, "readd"))


def _state(g):
    """Everything a reader can observe, in row order."""
    recs = g.scroll_all(with_vectors=True)
    return ([(r.id, r.payload.to_dict(), r.vector.tobytes()) for r in recs],
            len(g))


def _hits(g, q):
    return [[(h.id, h.score) for h in res] for res in g.search(q, k=5)]


def _files(root):
    return {p: (root / p).read_bytes() for p in sorted(os.listdir(root))
            if not p.startswith(".")}


@pytest.mark.parametrize("steps", ["base", "delta", "compacted_delta",
                                   "planes"])
def test_both_packages_write_the_same_bytes(steps, tmp_path, fixed_uuid):
    """Base (format 3), a row-indexed delta, an id-keyed delta after a
    compaction, and a planes sidecar: the same files, byte for byte."""
    out = []
    for name, pkg in (("jax", JAX), ("port", PORT)):
        root = tmp_path / name
        g = _build(pkg)
        pkg[1].save_gallery(g, root)
        if steps != "base":
            _churn(pkg, g)
            if steps == "compacted_delta":
                g.compact()
            pkg[1].save_gallery(g, root)
        if steps == "planes":
            pkg[1].save_capacity_planes(g, root)
        out.append(_files(root))
    assert list(out[0]) == list(out[1])
    for f in out[0]:
        assert out[0][f] == out[1][f], f
    if steps == "compacted_delta":
        meta = json.loads(tnative.snapshot_read(
            tmp_path / "port" / "snap.rbod.d1")[1].decode())
        assert "rows" not in meta  # downgraded to id-keyed ops


@pytest.mark.parametrize("mmap_vectors", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_loads_what_the_other_wrote(direction, mmap_vectors,
                                                 tmp_path):
    src, dst = (JAX, PORT) if direction == "jax_to_port" else (PORT, JAX)
    g = _build(src)
    src[1].save_gallery(g, tmp_path)
    _churn(src, g)
    src[1].save_gallery(g, tmp_path)            # delta 1
    g.upsert(["p00003"], np.ones((1, DIM), np.float32),
             _payloads(src[0], 3, 1, "late"))
    src[1].save_gallery(g, tmp_path)            # delta 2
    kw = {"device": "cpu"} if dst is PORT else {}
    g2 = dst[1].load_gallery("snap", tmp_path, mmap_vectors=mmap_vectors,
                             **kw)
    assert _state(g2) == _state(g)
    assert list(g2._alive[: g2._nrows]) == list(g._alive[: g._nrows])
    q = np.random.default_rng(3).normal(size=(3, DIM)).astype(np.float32)
    for a, b in zip(_hits(g2, q), _hits(g, q)):
        assert [x[0] for x in a] == [x[0] for x in b]
        np.testing.assert_allclose([x[1] for x in a], [x[1] for x in b],
                                   atol=1e-6)
    assert g2.get_by_path("/img/42.png").payload.class_name == "readd0"
    assert g2.retrieve(["p00099"]) == []


def test_port_load_is_lazy_and_replays_row_deltas_in_place(tmp_path):
    """A format-3 mmap load with a row-indexed delta chain materialises no
    id list, id map or path index; lookups probe the raw tables and see
    the replayed state; a write after it continues the chain."""
    g = _build(PORT)
    tpersist.save_gallery(g, tmp_path)
    _churn(PORT, g)
    tpersist.save_gallery(g, tmp_path)
    g2 = tpersist.load_gallery("snap", tmp_path, mmap_vectors=True,
                               device="cpu")
    assert g2._ids_list is None and g2._id_map is None
    assert g2._payloads._paths_lazy is not None
    assert g2.retrieve(["p00042"])[0].payload.class_name == "readd0"
    assert g2.retrieve(["p00099"]) == [] and g2._id_map is None
    assert _state(g2) == _state(g)
    before = (tmp_path / "snap.rbod").read_bytes()
    g2.upsert(["fresh"], np.ones((1, DIM), np.float32),
              _payloads(tschema, 5, 1, "new"))
    assert (tmp_path / "snap.rbod").read_bytes() == before  # COW pages
    tpersist.save_gallery(g2, tmp_path)
    assert (tmp_path / "snap.rbod.d2").exists()
    g3 = tpersist.load_gallery("snap", tmp_path, device="cpu")
    assert g3.retrieve(["fresh"])[0].payload.class_name == "new2"


def test_delta_save_removes_the_stale_planes_sidecar(tmp_path):
    """The reference leaves a sidecar that a delta save has made stale on
    disk; the port removes it. Both fall back to the device build."""
    for pkg, kept in ((JAX, True), (PORT, False)):
        root = tmp_path / ("j" if kept else "t")
        g = _build(pkg)
        pkg[1].save_gallery(g, root)
        sidecar = pkg[1].save_capacity_planes(g, root)
        assert g._planes_path == str(sidecar)
        g.delete(ids=["p00001"])
        pkg[1].save_gallery(g, root)
        assert sidecar.exists() == kept
        assert (g._planes_path is not None) == kept


def test_planes_bf16_without_ml_dtypes_is_ml_dtypes_rounding():
    """Round-to-nearest-even on the f32 bit pattern equals ml_dtypes'
    bf16 cast, ties and subnormals included."""
    import ml_dtypes

    rng = np.random.default_rng(4)
    x = np.concatenate([
        rng.normal(size=4096).astype(np.float32),
        np.array([0.0, -0.0, 1e-40, -1e-40, 3.4e38, 1.0 + 2 ** -8,
                  1.0 + 3 * 2 ** -8, np.inf, -np.inf], np.float32)])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tplanes.bf16_bits(x), want)
    assert tplanes.bf16_bits(np.array([np.nan], np.float32))[0] & 0x7FC0 \
        == 0x7FC0


def test_native_runtime_builds_outside_the_package():
    """The port's library builds into build/native (git-ignored), under a
    name hashed from its source, and filters like NumPy."""
    assert tnative.available()
    lib = tnative.library_path()
    assert lib.exists() and lib.parent.name == "native" \
        and lib.parent.parent.name == "build"
    rng = np.random.default_rng(5)
    n = 5000
    c1 = rng.integers(0, 5, n).astype(np.int32)
    c2 = rng.integers(0, 3, n).astype(np.int32)
    b = rng.random(n) < 0.5
    got = tnative.filter_mask([c1, c2], [2, 1], [b], [True], n)
    np.testing.assert_array_equal(got, (c1 == 2) & (c2 == 1) & b)
    np.testing.assert_array_equal(tnative.filter_mask([], [], [], [], 4),
                                  np.ones(4, bool))


@pytest.mark.parametrize("writer", ["port_native", "port_numpy", "jax"])
def test_snapshot_container_is_one_format(writer, tmp_path):
    v = np.random.default_rng(6).normal(size=(33, 7)).astype(np.float32)
    blob = b'{"k": 1}'
    path = tmp_path / "x.rbod"
    {"port_native": tnative.snapshot_write,
     "port_numpy": tnative._snapshot_write_py,
     "jax": jnative.snapshot_write}[writer](path, v, blob)
    for read in (tnative.snapshot_read, tnative._snapshot_read_py,
                 jnative.snapshot_read):
        v2, b2 = read(path)
        np.testing.assert_array_equal(v2, v)
        assert b2 == blob
    assert tnative.snapshot_header(path) == (33, 7, len(blob))
    path.write_bytes(path.read_bytes()[:-5])  # torn write
    for read in (tnative.snapshot_read, tnative._snapshot_read_py):
        with pytest.raises(tnative.SnapshotFormatError):
            read(path)


def test_store_roundtrip_listing_and_collection_tombstones(tmp_path):
    """save_store / load_store / list_snapshots of the port over a root
    the JAX store wrote, and the other way round."""
    js = JStore()
    a = js.create_collection("a", dim=DIM)
    a.upsert(["x", "y"], np.eye(2, DIM, dtype=np.float32),
             _payloads(jschema, 0, 2))
    js.create_collection("gone", dim=DIM)
    jpersist.save_store(js, tmp_path)
    ts = tpersist.load_store(tmp_path, device="cpu")
    assert ts.list_collections() == js.list_collections()
    ts.delete_collection("gone")
    ts.get("a").delete(ids=["y"])
    tpersist.save_store(ts, tmp_path)
    assert tpersist.list_snapshots(tmp_path) == \
        jpersist.list_snapshots(tmp_path) == [("a", 1)]
    back = jpersist.load_store(tmp_path)
    assert back.list_collections() == [("a", 1)]
    assert back.get("a").retrieve(["x"])[0].payload.class_name == "c0"


def test_memmap_vectors_grow_and_search_like_ram(tmp_path):
    path = tmp_path / "vecs.f32"
    disk = TGallery("mm", dim=DIM, capacity=4, vectors_path=str(path),
                    device="cpu")
    ram = TGallery("mm", dim=DIM, capacity=4, device="cpu")
    v = np.random.default_rng(7).normal(size=(50, DIM)).astype(np.float32)
    for g in (disk, ram):
        for lo in range(0, 50, 10):  # growth past the file's first size
            g.upsert([f"p{i}" for i in range(lo, lo + 10)], v[lo:lo + 10],
                     _payloads(tschema, lo, 10))
        g.delete(ids=["p3"])
    assert isinstance(disk._vectors, np.memmap)
    assert os.path.getsize(path) >= 50 * DIM * 4
    assert _state(disk) == _state(ram)
    q = v[:3]
    assert _hits(disk, q) == _hits(ram, q)
    with pytest.raises(FileExistsError):
        TGallery("again", dim=DIM, vectors_path=str(path), device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lazy_load_equals_eager_load(seed, tmp_path):
    """Random reads and writes on a lazily loaded gallery and on an eager
    twin (ids materialised up front) agree at every step."""
    rng = np.random.default_rng(seed)
    g = _build(PORT, n=64, seed=seed)
    tpersist.save_gallery(g, tmp_path)
    _churn(PORT, g, seed)
    tpersist.save_gallery(g, tmp_path)
    lazy = tpersist.load_gallery("snap", tmp_path, mmap_vectors=True,
                                 device="cpu")
    eager = tpersist.load_gallery("snap", tmp_path, device="cpu")
    _ = eager._id_to_row, eager._payloads._ensure_paths()
    for _ in range(25):
        kind = int(rng.integers(0, 6))
        i = int(rng.integers(0, 80))
        pid = f"p{i:05d}"
        res = []
        for gal in (lazy, eager):
            r = np.random.default_rng(i)
            if kind == 0:
                gal.upsert([pid], r.normal(size=(1, DIM)).astype(np.float32),
                           _payloads(tschema, i, 1, "w"))
                res.append(None)
            elif kind == 1:
                res.append(gal.delete(ids=[pid]))
            elif kind == 2:
                res.append([(x.id, x.payload.to_dict())
                            for x in gal.retrieve([pid])])
            elif kind == 3:
                res.append(_hits(gal, r.normal(size=(1, DIM)).astype(
                    np.float32)))
            elif kind == 4:
                rec = gal.get_by_path(f"/img/{i}.png")
                res.append(None if rec is None else rec.id)
            else:
                res.append((gal.count(tschema.Filter(
                    must={"class_name": "c1"})), _state(gal)))
        assert res[0] == res[1]
