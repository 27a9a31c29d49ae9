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
    assert hit[0][0].id == "a" and g._cap.view is not None
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
        assert (g._cap.view is not None) == (tier == "capacity")
        assert (g._dev_bf16 is not None) == (tier == "mirror")
        # exact=True never leaves the f32 mirror.
        g.search(vecs[:1], k=1)
        assert g._dev_f32 is not None


# (rows, dim, distance, exact, method, meshed, device type, past the
# budget, the sharded view in its capacity layout) -> (route, sub-tier).
_BIG = TGallery.INT8_SCAN_MIN_ROWS
ROUTES = {
    "exact": ((1000, 8, "cosine", True, None, False, "cuda", False, False),
              ("exact", None)),
    "exact-past-budget": ((1000, 8, "cosine", True, None, False, "cuda",
                           True, False), ("exact", None)),
    "bf16-under-min-rows": ((1000, 8, "cosine", False, None, False, "cuda",
                             False, False), ("bf16", None)),
    "int8-cuda": ((_BIG, 8, "cosine", False, None, False, "cuda", False,
                   False), ("int8", None)),
    "bf16-cpu": ((_BIG, 8, "cosine", False, None, False, "cpu", False,
                  False), ("bf16", None)),
    "capacity-past-budget": ((_BIG, 8, "cosine", False, None, False, "cuda",
                              True, False), ("capacity", None)),
    "odd-dim-never-capacity": ((_BIG, 7, "cosine", False, None, False,
                                "cuda", True, False), ("int8", None)),
    "dot": ((_BIG, 8, "dot", False, None, False, "cuda", True, False),
            ("bf16", None)),
    "euclid": ((_BIG, 8, "euclid", False, None, False, "cuda", True, False),
               ("bf16", None)),
    "manhattan": ((_BIG, 8, "manhattan", True, None, False, "cpu", False,
                   False), ("exact", None)),
    "pinned-int4": ((1000, 8, "cosine", True, "int4", True, "cpu", False,
                     False), ("int4", None)),
    "mesh-exact": ((1000, 8, "cosine", True, None, True, "cpu", False,
                    False), ("sharded", "exact")),
    "mesh-int8-cuda": ((_BIG, 8, "cosine", False, None, True, "cuda", True,
                        False), ("sharded", "int8")),
    "mesh-bf16-cpu": ((_BIG, 8, "cosine", False, "sharded", True, "cpu",
                       False, False), ("sharded", "bf16")),
    "mesh-capacity-layout": ((_BIG, 8, "cosine", False, None, True, "cuda",
                              True, True), ("sharded", "int4")),
    "pinned-sharded-bf16": ((1000, 8, "cosine", True, "sharded_bf16", True,
                             "cpu", False, True), ("sharded", "bf16")),
    "pinned-sharded-no-mesh": ((1000, 8, "cosine", False, "sharded_exact",
                                False, "cpu", False, False),
                               ("sharded", "exact")),
}
ROUTE_ERRORS = {
    "unknown-method": ((1000, 8, "cosine", True, "int16", False, "cpu",
                        False, False), "unknown method"),
    "malformed-sharded": ((1000, 8, "cosine", True, "shardedfoo", True,
                           "cpu", False, False), "unknown method"),
    "unknown-sharded-tier": ((1000, 8, "cosine", True, "sharded_int16", True,
                              "cpu", False, False), "unknown sharded tier"),
    "int8-not-cosine": ((1000, 8, "dot", False, "int8", False, "cuda", False,
                         False), "requires a cosine"),
    "capacity-not-cosine": ((1000, 8, "euclid", False, "capacity", False,
                             "cuda", False, False), "requires a cosine"),
    "sharded-int4-not-cosine": ((1000, 8, "manhattan", False,
                                 "sharded_int4", True, "cpu", False, False),
                                "requires a cosine"),
    "int4-odd-dim": ((1000, 7, "cosine", False, "int4", False, "cuda", False,
                      False), "even dim"),
    "capacity-odd-dim": ((1000, 7, "cosine", False, "capacity", False, "cpu",
                          False, False), "even dim"),
    "exact-in-capacity-layout": ((1000, 8, "cosine", True, None, True, "cpu",
                                  True, True), "exact search is unavailable"),
}


def _route(monkeypatch, rows, dim, distance, exact, method, meshed, device,
           past_budget, shard_capacity):
    # One byte past or exactly at the standard mirrors' 5 bytes a dim.
    monkeypatch.setattr(TGallery, "CAPACITY_AUTO_BYTES",
                        rows * dim * 5 - (1 if past_budget else 0))
    return TGallery._route(rows, dim, distance, exact, method, meshed,
                           device, shard_capacity=shard_capacity)


@pytest.mark.parametrize("case", ROUTES)
def test_route_picks_one_tier(monkeypatch, case):
    """The one decision of which tier serves a search: a mesh routes to the
    sharded tier, exact to f32, the non-cosine metrics to bf16, past the
    budget (even dims) to the capacity tier, int8 on CUDA from
    INT8_SCAN_MIN_ROWS; the sharded sub-tier by the same rules, int4 in its
    capacity layout, and pinned method strings as they are."""
    args, want = ROUTES[case]
    assert _route(monkeypatch, *args) == want


@pytest.mark.parametrize("case", ROUTE_ERRORS)
def test_route_refuses_what_the_store_does_not_serve(monkeypatch, case):
    args, match = ROUTE_ERRORS[case]
    with pytest.raises(ValueError, match=match):
        _route(monkeypatch, *args)


@pytest.mark.parametrize("k, rows, depth", [
    (1, 200, 200), (1, 10 ** 6, 256), (32, 200, 200), (32, 10 ** 6, 256),
    (33, 200, 200), (33, 10 ** 6, 264), (100, 200, 200),
    (100, 10 ** 6, 800)])
def test_rescore_depth(k, rows, depth):
    """Eight candidates a hit, at least 256, at most the rows: so the int8
    tier's captured graphs (GRAPH_MAX_RESCORE) take k up to 32."""
    from retrieval_based_object_detection_tpu_torch.gallery import search

    assert search.rescore_depth(k, rows) == depth
    assert (depth <= search.GRAPH_MAX_RESCORE) == (k <= 32 or rows <= 256)


@pytest.mark.parametrize("write", ["upsert", "delete"])
def test_one_write_clears_every_mask_cache_and_queues_one_op(write):
    """With the mirrors, the capacity view and the sharded view all live
    and each holding a filter's mask, one upsert or one delete empties
    every mask cache and queues exactly one op on each live view."""
    from retrieval_based_object_detection_tpu_torch.parallel.mesh import (
        gallery_mesh)

    rng = np.random.default_rng(5)
    g = TGallery("w", dim=8, device="cpu")
    g.upsert([f"p{i}" for i in range(40)],
             rng.normal(size=(40, 8)).astype(np.float32),
             [tschema.Payload(data_type="o", class_name=f"c{i % 3}")
              for i in range(40)])
    g.attach_mesh(gallery_mesh(2, device="cpu"))
    flt = tschema.Filter(must={"class_name": "c1"})
    q = rng.normal(size=8).astype(np.float32)
    for method in ("bf16", "capacity", "sharded"):
        assert g.search(q, k=3, flt=flt, method=method)[0]
    caches = (g._masks, g._cap.masks, g._shard.masks)
    assert all(len(c) == 1 for c in caches)
    assert g._cap.view is not None and g._shard_view is not None
    if write == "upsert":
        g.upsert(["p1", "new"], rng.normal(size=(2, 8)).astype(np.float32),
                 [tschema.Payload(data_type="o", class_name="c1")] * 2)
        kind = "rows"
    else:
        assert g.delete(["p4", "p7"]) == 2
        kind = "mask"
    assert not any(caches)
    assert [op[0] for op in g._cap.pending] == [kind]
    assert [op[0] for op in g._shard.pending] == [kind]
    for method in ("bf16", "capacity", "sharded"):
        hits = g.search(q, k=40, flt=flt, method=method)[0]
        assert {h.id for h in hits} == {
            r.id for r in g.scroll_all(flt)}
    assert not g._cap.pending and not g._shard.pending


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
