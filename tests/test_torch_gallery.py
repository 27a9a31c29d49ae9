"""Port parity: the gallery store, replayed against the JAX package.

The same upsert / scroll / count / distinct / filter / search sequences run
on both stores with the same numpy-seeded vectors and payloads. Host-side
results must be identical; search hits agree in id sets and in scores to
1e-5 (the same f32 math summed in another order).
"""

import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery.store import Gallery as JGallery
from retrieval_based_object_detection_tpu_torch.gallery import schema as tschema
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
    VectorStore,
)

DIM = 24
CLASSES = ("cola", "fanta", "sprite")


def _payload(mod, i, cls, seg, aug, delegate=None):
    return mod.Payload(
        data_type="natural_images" if i % 5 == 0 else "original_images",
        class_name=cls, img_path=f"/data/{cls}/{i}.png",
        is_cropped=True, is_segmented=seg, is_augmented=aug,
        is_delegate=delegate is not None, delegate_type=delegate)


def _ops(seed):
    """A random write sequence: appends, overwrites, in-batch duplicates,
    delegate points."""
    rng = np.random.default_rng(seed)
    ops = []
    for step in range(6):
        n = int(rng.integers(5, 40))
        idx = rng.integers(0, 120, n)  # ids collide across and within batches
        vecs = rng.normal(size=(n, DIM)).astype(np.float32)
        rows = []
        for j, i in enumerate(idx):
            cls = CLASSES[int(i) % 3]
            delegate = "average" if (i % 17 == 0) else None
            rows.append((f"p{i}", vecs[j], (int(i), cls, bool(i % 2),
                                            bool(i % 7 == 0), delegate)))
        ops.append(rows)
    return ops


def _apply(g, mod, rows):
    g.upsert([r[0] for r in rows], np.stack([r[1] for r in rows]),
             [_payload(mod, *r[2]) for r in rows])


FILTERS = [
    None,
    dict(must={"class_name": "cola"}),
    dict(must={"is_segmented": True, "is_delegate": False}),
    dict(must={"class_name": "fanta"}, must_not={"is_augmented": True}),
    dict(must_not=(("class_name", "cola"), ("class_name", "zzz"))),
    dict(should=(("class_name", "cola"), ("is_augmented", True))),
    dict(must={"img_path": "/data/cola/3.png"}),
    dict(must={"class_name": "unknown"}),
    "pre_a",
]


def _filters(mod):
    for spec in FILTERS:
        if spec is None:
            yield None
        elif spec == "pre_a":
            yield mod.Filter.for_case("pre_a") & mod.Filter(
                must={"data_type": "original_images"})
        else:
            yield mod.Filter(**spec)


def _rec(r, vectors=False):
    out = (r.id, r.payload.to_dict())
    return out + (r.vector.tolist(),) if vectors else out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_reads_match_jax(seed):
    jg = JGallery("replay", dim=DIM, capacity=16)
    tg = TGallery("replay", dim=DIM, capacity=16, device="cpu")
    for rows in _ops(seed):
        _apply(jg, jschema, rows)
        _apply(tg, tschema, rows)
        assert len(tg) == len(jg) and tg.write_seq == jg.write_seq
        for jf, tf in zip(_filters(jschema), _filters(tschema)):
            assert tg.count(tf) == jg.count(jf)
            assert [_rec(r, True) for r in tg.scroll_all(tf, True)] == \
                [_rec(r, True) for r in jg.scroll_all(jf, True)]
            jpage, jnext = jg.scroll(jf, limit=4, offset=2)
            tpage, tnext = tg.scroll(tf, limit=4, offset=2)
            assert [_rec(r) for r in tpage] == [_rec(r) for r in jpage]
            assert tnext == jnext
            np.testing.assert_array_equal(tg.vectors_matching(tf),
                                          jg.vectors_matching(jf))
        for fld in ("class_name", "delegate_type", "data_type"):
            assert tg.distinct(fld) == jg.distinct(fld)


@pytest.mark.parametrize("method", ["exact", "bf16", "int8"])
def test_replay_search_matches_jax(method):
    """Searches interleaved with writes, so the port's incremental mirror
    patches (overwrites and appends) are exercised against the JAX ones."""
    rng = np.random.default_rng(11)
    jg = JGallery("s", dim=DIM, capacity=16)
    tg = TGallery("s", dim=DIM, capacity=16, device="cpu")
    for rows in _ops(5):
        _apply(jg, jschema, rows)
        _apply(tg, tschema, rows)
        queries = rng.normal(size=(3, DIM)).astype(np.float32)
        for jf, tf in zip(_filters(jschema), _filters(tschema)):
            jres = jg.search(queries, k=5, flt=jf, method=method)
            tres = tg.search(queries, k=5, flt=tf, method=method)
            for jh, th in zip(jres, tres):
                assert {h.id for h in th} == {h.id for h in jh}
                np.testing.assert_allclose(
                    sorted(h.score for h in th), sorted(h.score for h in jh),
                    atol=1e-5)


def test_auto_routing_on_cpu_serves_bf16_not_int8(monkeypatch):
    """exact=False on a CPU store routes to bf16 at any size (int8 is the
    CUDA route past INT8_SCAN_MIN_ROWS); exact=True is f32."""
    g = TGallery("r", dim=8, device="cpu")
    rng = np.random.default_rng(0)
    g.upsert([f"p{i}" for i in range(300)],
             rng.normal(size=(300, 8)).astype(np.float32),
             [tschema.Payload(data_type="original_images", class_name="x")
              for _ in range(300)])
    monkeypatch.setattr(TGallery, "INT8_SCAN_MIN_ROWS", 100)
    g.search(np.ones(8, np.float32), exact=False)
    assert g._dev_bf16 is not None and g._dev_int8 is None
    g.search(np.ones(8, np.float32))
    assert g._dev_f32 is not None and g._dev_int8 is None


def test_unported_paths_raise_naming_the_roadmap():
    """Every tier of the store is served: the sharded tier routes once a
    mesh is attached (and asks for one before), the capacity tier, deletes
    and the non-cosine metrics too; unknown methods are a ValueError."""
    from retrieval_based_object_detection_tpu_torch.parallel.mesh import (
        gallery_mesh, make_mesh)

    g = TGallery("u", dim=8, device="cpu")
    g.upsert(["a", "b"], np.eye(2, 8, dtype=np.float32),
             [tschema.Payload(data_type="original_images", class_name="x")]
             * 2)
    for method in ("sharded", "sharded_int8"):
        with pytest.raises(ValueError, match="attach_mesh"):
            g.search(np.ones(8, np.float32), method=method)
    with pytest.raises(ValueError, match="no 'gallery' axis"):
        g.attach_mesh(make_mesh({"dp": 2}, ["cpu"] * 2))
    g.attach_mesh(gallery_mesh(2, device="cpu"))
    for method in (None, "sharded", "sharded_exact", "sharded_int8",
                   "sharded_int4"):
        hit = g.search(np.eye(1, 8, dtype=np.float32), k=1, method=method)
        assert hit[0][0].id == "a"
    assert g._shard_view is not None and g._dev_f32 is None
    with pytest.raises(ValueError, match="unknown sharded tier"):
        g.search(np.ones(8, np.float32), method="sharded_int16")
    g.detach_mesh()
    assert g._shard_view is None
    with pytest.raises(ValueError, match="unknown method"):
        g.search(np.ones(8, np.float32), method="int16")
    # Asked for by name the capacity tier serves, at any size.
    hit = g.search(np.eye(1, 8, dtype=np.float32), k=1, method="capacity")
    assert hit[0][0].id == "a" and g._cap_view is not None
    assert g.delete(["a"]) == 1 and len(g) == 1
    assert g.search(np.eye(1, 8, dtype=np.float32), k=2,
                    method="capacity")[0][0].id == "b"
    e = TGallery("e", dim=8, distance="euclid", device="cpu")
    e.upsert(["p", "q"], np.stack([np.zeros(8), np.full(8, 3.0)]).astype(
        np.float32), [tschema.Payload(data_type="o", class_name="x")] * 2)
    hits = e.search(np.ones(8, np.float32), k=2)[0]
    assert [h.id for h in hits] == ["p", "q"]
    np.testing.assert_allclose([h.score for h in hits],
                               [-np.sqrt(8), -np.sqrt(32)], rtol=1e-6)
    with pytest.raises(ValueError, match="limit"):
        g.scroll(limit=0)


@pytest.mark.parametrize("min_rows", [10 ** 9, 1])
def test_auto_search_never_picks_the_unported_capacity_tier(monkeypatch,
                                                            min_rows):
    """Past CAPACITY_AUTO_BYTES of standard mirrors an inexact search
    auto-routes to the capacity tier, as in the JAX store, and below it to
    a mirror tier (bf16 here: int8 is the CUDA route), whatever
    INT8_SCAN_MIN_ROWS says; the constant is sized for an 80 GB card.
    The name is kept from before the capacity tier was ported, when auto
    search had to avoid it; what it checks now is the routing above."""
    assert TGallery.CAPACITY_AUTO_BYTES >= 32 << 30
    monkeypatch.setattr(TGallery, "INT8_SCAN_MIN_ROWS", min_rows)
    rng = np.random.default_rng(4)
    vecs = rng.normal(size=(40, 8)).astype(np.float32)
    pl = tschema.Payload(data_type="original_images", class_name="x")
    for budget, tier in ((40 * 8 * 5, "mirror"), (40 * 8 * 5 - 1,
                                                  "capacity")):
        monkeypatch.setattr(TGallery, "CAPACITY_AUTO_BYTES", budget)
        g = TGallery("big", dim=8, device="cpu")
        g.upsert([f"p{i}" for i in range(40)], vecs, [pl] * 40)
        hits = g.search(vecs[:3], k=1, exact=False)
        assert [h[0].id for h in hits] == ["p0", "p1", "p2"]
        assert (g._cap_view is not None) == (tier == "capacity")
        assert (g._dev_bf16 is not None) == (tier == "mirror")
        # exact=True never leaves the f32 mirror.
        g.search(vecs[:1], k=1)
        assert g._dev_f32 is not None


def test_vector_store_crud_and_device():
    vs = VectorStore(device="cpu")
    g = vs.create_collection("a", dim=8)
    assert g.device == torch.device("cpu")
    vs.create_collection("b", dim=8)
    vs.rename_collection("b", "c")
    assert [n for n, _ in vs.list_collections()] == ["a", "c"]
    with pytest.raises(KeyError):
        vs.create_collection("a", recreate=False)
    vs.delete_collection("a")
    assert "a" not in vs and "c" in vs
    assert vs.delete_all_collections() == 1


def test_search_sees_host_writes_after_mirror_build():
    """The mirrors are device copies: a later overwrite must reach them
    through the dirty-range patch, never by aliasing host memory."""
    g = TGallery("alias", dim=4, device="cpu")
    pl = tschema.Payload(data_type="original_images", class_name="x")
    g.upsert(["a", "b"], np.eye(4, dtype=np.float32)[:2], [pl, pl])
    assert g.search(np.array([1, 0, 0, 0], np.float32), k=1)[0][0].id == "a"
    g.upsert(["a"], np.array([[0, 0, 1, 0]], np.float32), [pl])
    hits = g.search(np.array([1, 0, 0, 0], np.float32), k=2)[0]
    assert all(h.score < 0.5 for h in hits)
    assert g.search(np.array([0, 0, 1, 0], np.float32), k=1)[0][0].id == "a"


def test_rwlock_readers_share_and_a_writer_excludes():
    """The copied reader-writer lock: two readers hold it together, a
    writer waits for both and then holds it alone."""
    import threading

    from retrieval_based_object_detection_tpu_torch.utils.locks import RWLock

    lock = RWLock()
    both_in = threading.Barrier(3, timeout=10)
    release = threading.Event()
    order = []

    def reader():
        with lock.read():
            both_in.wait()          # proves two readers are inside at once
            release.wait(timeout=10)
            order.append("read-done")

    def writer():
        with lock.write():
            order.append("write")

    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in readers:
        t.start()
    both_in.wait()
    w = threading.Thread(target=writer)
    w.start()
    w.join(timeout=0.2)
    assert w.is_alive()             # blocked behind the readers
    release.set()
    for t in readers + [w]:
        t.join(timeout=10)
        assert not t.is_alive()
    assert order == ["read-done", "read-done", "write"]
