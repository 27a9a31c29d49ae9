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
    g = TGallery("u", dim=8, device="cpu")
    g.upsert(["a"], np.ones((1, 8), np.float32),
             [tschema.Payload(data_type="original_images", class_name="x")])
    for method in ("capacity", "sharded", "sharded_int8"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            g.search(np.ones(8, np.float32), method=method)
    with pytest.raises(ValueError, match="unknown method"):
        g.search(np.ones(8, np.float32), method="int16")
    with pytest.raises(NotImplementedError, match="A.4"):
        g.search(np.ones(8, np.float32), method="capacity")
    # Asked for by name it raises at any size, also past the auto budget.
    old = TGallery.CAPACITY_AUTO_BYTES
    TGallery.CAPACITY_AUTO_BYTES = 1
    try:
        with pytest.raises(NotImplementedError, match="A.4"):
            g.search(np.ones(8, np.float32), method="capacity")
    finally:
        TGallery.CAPACITY_AUTO_BYTES = old
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        g.delete(["a"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TGallery("e", dim=8, distance="euclid", device="cpu")
    with pytest.raises(ValueError, match="limit"):
        g.scroll(limit=0)


@pytest.mark.parametrize("min_rows", [10 ** 9, 1])
def test_auto_search_never_picks_the_unported_capacity_tier(monkeypatch,
                                                            min_rows):
    """Past CAPACITY_AUTO_BYTES of standard mirrors the JAX store routes an
    inexact search to its capacity tier. The port has no such tier yet, so
    its auto route must stay on a tier it has (bf16 here: int8 is the CUDA
    route) and answer, not raise; the constant is sized for an 80 GB card."""
    assert TGallery.CAPACITY_AUTO_BYTES >= 32 << 30
    monkeypatch.setattr(TGallery, "CAPACITY_AUTO_BYTES", 64)
    monkeypatch.setattr(TGallery, "INT8_SCAN_MIN_ROWS", min_rows)
    rng = np.random.default_rng(4)
    g = TGallery("big", dim=8, device="cpu")
    vecs = rng.normal(size=(40, 8)).astype(np.float32)
    pl = tschema.Payload(data_type="original_images", class_name="x")
    g.upsert([f"p{i}" for i in range(40)], vecs, [pl] * 40)
    assert 40 * 8 * 5 > TGallery.CAPACITY_AUTO_BYTES
    hits = g.search(vecs[:3], k=1, exact=False)
    assert [h[0].id for h in hits] == ["p0", "p1", "p2"]
    assert g._dev_bf16 is not None


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
