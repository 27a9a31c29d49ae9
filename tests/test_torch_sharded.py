"""Port parity: the sharded gallery tier against the JAX package's.

JAX runs on its 8 forced host devices with the Pallas scans interpreted,
as its own tests run them; the port runs its shards on the one CPU device
(a mesh that repeats it). The same seeded rows go through both:
``shard_rows`` is equal on a table of sizes; the three sharded top-k
functions agree (int8 codes and per-shard integer scan scores bit for bit,
f32 scores within 1e-6, ids equal, as sets only across tied scores); ties
across shards break by shard order in both; and the store-level cases of
tests/test_sharded_store.py are replayed on a JAX and a port gallery side
by side, the JAX store being the oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery import search as jsearch
from retrieval_based_object_detection_tpu.gallery import sharded as jsh
from retrieval_based_object_detection_tpu.gallery.store import (
    Gallery as JGallery,
    VectorStore as JStore,
)
from retrieval_based_object_detection_tpu.ops.int4_scan import (
    int4_scan_scores as jax_int4_scan,
)
from retrieval_based_object_detection_tpu.ops.int8_scan import (
    int8_scan_scores as jax_int8_scan,
)
from retrieval_based_object_detection_tpu.parallel.mesh import (
    gallery_mesh as jgallery_mesh,
)
from retrieval_based_object_detection_tpu_torch.gallery import schema as tschema
from retrieval_based_object_detection_tpu_torch.gallery import search as tsearch
from retrieval_based_object_detection_tpu_torch.gallery import sharded as tsh
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
    VectorStore as TStore,
)
from retrieval_based_object_detection_tpu_torch.ops import int4_scan as S4
from retrieval_based_object_detection_tpu_torch.ops import int8_scan as S8
from retrieval_based_object_detection_tpu_torch.parallel.mesh import (
    gallery_mesh,
    make_mesh,
)

DIM = 32
TOL = 1e-6


def _jmesh(n: int) -> JMesh:
    return JMesh(np.array(jax.devices()[:n]).reshape(n), ("gallery",))


def _tmesh(n: int):
    return make_mesh({"gallery": n}, ["cpu"] * n)


def _assert_topk(js, ji, ts, ti, tol=TOL):
    """Equal top-k: scores within ``tol``, ids equal by position except
    inside a run of tied scores, where they are compared as sets."""
    js, ji, ts, ti = map(np.asarray, (js, ji, ts, ti))
    np.testing.assert_allclose(ts, js, atol=tol)
    for srow, a, b in zip(js, ji, ti):
        assert set(a.tolist()) == set(b.tolist()), (a, b)
        for j in range(len(srow)):
            tied = any(abs(srow[j] - srow[i]) <= tol
                       for i in (j - 1, j + 1) if 0 <= i < len(srow))
            assert tied or a[j] == b[j], (j, a, b, srow)


# -------------------------------------------------------- shard_rows


@pytest.mark.parametrize("n_rows,n_shards", [
    (0, 1), (1, 8), (255, 1), (257, 1), (700, 4), (1000, 8),
    (131_071 * 4, 4), (131_072 * 4, 4), (1 << 20, 4), ((1 << 20) + 1, 8),
    (10_485_760, 4), (3_000_000, 3)])
def test_shard_rows_matches_jax(n_rows, n_shards):
    assert tsh.shard_rows(n_rows, n_shards) == \
        jsh.shard_rows(n_rows, n_shards)


# ------------------------------------------- the sharded top-k functions


def _views(rng, n=1000, n_shards=4, d=64):
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[::11] = False
    jv = jsh.ShardedGallerySearcher(vectors, mask, _jmesh(n_shards))
    tv = tsh.ShardedGallerySearcher(vectors, mask, _tmesh(n_shards))
    return vectors, mask, jv, tv


@pytest.mark.parametrize("method", ["exact", "int8", "int4"])
def test_sharded_topk_functions_match_jax(method):
    """``sharded_topk`` / ``sharded_int8_topk`` / ``sharded_int4_topk``
    through the searcher: the same layout, the same per-shard integer
    scores bit for bit, the same merged top-k."""
    rng = np.random.default_rng(7)
    vectors, mask, jv, tv = _views(rng)
    assert tv.rows_per * 4 == jv.dev_vectors.shape[0]
    jrows = np.asarray(jv.dev_vectors)
    np.testing.assert_array_equal(
        np.concatenate([t.numpy() for t in tv.dev_vectors]), jrows)
    q = rng.normal(size=(5, 64)).astype(np.float32)
    js, ji = jv.search(q, k=7, method=method)
    ts, ti = tv.search(q, k=7, method=method)
    _assert_topk(js, ji, ts, ti)
    if method == "exact":
        return
    q_i8 = np.asarray(jsearch.quantize_rows_int8(
        jsearch.l2_normalize(jnp.asarray(q))))
    tq_i8 = tsearch.quantize_rows_int8(
        tsearch.l2_normalize(torch.from_numpy(q)))
    np.testing.assert_array_equal(tq_i8.numpy(), q_i8)
    R = tv.rows_per
    jmask = np.asarray(jv.dev_mask)
    for s in range(4):
        pen = np.where(jmask[s * R:(s + 1) * R], 0.0,
                       jsearch.NEG_INF).astype(np.float32)
        if method == "int8":
            jcodes = np.asarray(jv._dev_int8)[s * R:(s + 1) * R]
            np.testing.assert_array_equal(tv._dev_int8[s].numpy(), jcodes)
            want = jax_int8_scan(jnp.asarray(q_i8), jnp.asarray(jcodes),
                                 jnp.asarray(pen), tile_rows=256,
                                 interpret=True)
            got = S8.int8_scan_scores(tq_i8, tv._dev_int8[s],
                                      torch.from_numpy(pen))
        else:
            jp, jsc = (np.asarray(a)[s * R:(s + 1) * R]
                       for a in jv._dev_int4)
            tp, tsc = tv._dev_int4[s]
            np.testing.assert_array_equal(tp.numpy(), jp)
            # JAX's jitted packing multiplies by the f32 reciprocal of 7
            # where the port divides: scales one rounding step apart.
            np.testing.assert_allclose(tsc.numpy(), jsc, rtol=2.5e-7)
            want = jax_int4_scan(jnp.asarray(q_i8), jnp.asarray(tp.numpy()),
                                 jnp.asarray(tsc.numpy()), jnp.asarray(pen),
                                 tile_rows=256, interpret=True)
            got = S4.int4_scan_scores(tq_i8, tp, tsc, torch.from_numpy(pen))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method,k", [("exact", 4), ("exact", 6),
                                      ("int8", 4), ("int4", 6)])
def test_ties_across_shards_break_by_shard_order(method, k):
    """One row repeated once in each of 4 shards: every shard's copy
    scores the same, and both packages return them in shard order (JAX's
    ``lax.top_k`` keeps the lower index; the port's merge sorts stably)."""
    rng = np.random.default_rng(3)
    n, d = 1000, 64
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    dup = [10, 300, 600, 900]  # rows_per is 256: one copy per shard
    vectors[dup] = vectors[10]
    mask = np.ones(n, bool)
    jv = jsh.ShardedGallerySearcher(vectors, mask, _jmesh(4))
    tv = tsh.ShardedGallerySearcher(vectors, mask, _tmesh(4))
    q = vectors[10][None]
    js, ji = jv.search(q, k=k, method=method)
    ts, ti = tv.search(q, k=k, method=method)
    assert list(np.asarray(ji)[0, :4]) == dup
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), atol=TOL)


def test_merge_is_stable_on_equal_candidates():
    """The merge alone: equal scores keep shard order (the first shard's
    candidate first), whatever ``torch.topk`` would do."""
    scores = [torch.full((2, 3), 0.5) for _ in range(4)]
    idx = [torch.arange(3).expand(2, 3) for _ in range(4)]
    best_s, best_i = tsh._gather_merge(scores, idx, rows_per=100, k=5)
    assert best_i.tolist() == [[0, 1, 2, 100, 101]] * 2
    assert (best_s == 0.5).all()


# ----------------------------------------- the store-level cases (oracle)


def _mk(rng, n, start=0, cls=None):
    ids = [f"id{start + i}" for i in range(n)]
    vecs = rng.normal(size=(n, DIM)).astype(np.float32)
    pls = [dict(data_type="original_images",
                class_name=cls or ("a" if (start + i) % 2 else "b"),
                img_path=f"/t/{start + i}.png") for i in range(n)]
    return ids, vecs, pls


class Twin:
    """One JAX and one port gallery driven by the same calls; every read
    is compared, and the port's answer returned."""

    def __init__(self, name="sh"):
        self.j = JGallery(name, dim=DIM)
        self.t = TGallery(name, dim=DIM, device="cpu")

    def upsert(self, ids, vecs, pls):
        self.j.upsert(ids, vecs, [jschema.Payload(**p) for p in pls])
        self.t.upsert(ids, vecs, [tschema.Payload(**p) for p in pls])

    def delete(self, **kw):
        assert self.j.delete(**kw) == self.t.delete(**kw)

    def attach(self, n=8):
        self.j.attach_mesh(jgallery_mesh(n))
        self.t.attach_mesh(gallery_mesh(n, device="cpu"))

    def search(self, q, k=5, flt=None, tol=TOL, **kw):
        jf = jschema.Filter(must=flt) if flt else None
        tf = tschema.Filter(must=flt) if flt else None
        jres = self.j.search(q, k=k, flt=jf, **kw)
        tres = self.t.search(q, k=k, flt=tf, **kw)
        assert len(jres) == len(tres)
        for a, b in zip(jres, tres):
            ids = {h.id: h for h in a}
            _assert_topk([[h.score for h in a]],
                         [[list(ids).index(h.id) for h in a]],
                         [[h.score for h in b]],
                         [[list(ids).index(h.id) if h.id in ids else -1
                           for h in b]], tol=tol)
            for h in b:
                assert h.payload.to_dict() == ids[h.id].payload.to_dict()
        return tres


def _twin(rng, n=400):
    tw = Twin()
    ids, vecs, pls = _mk(rng, n)
    tw.upsert(ids, vecs, pls)
    return tw, ids, vecs


def test_attach_mesh_auto_routes_like_jax():
    rng = np.random.default_rng(0)
    tw, ids, vecs = _twin(rng)
    q = rng.normal(size=(3, DIM)).astype(np.float32)
    want = tw.search(q)  # single-device exact, both
    tw.attach()
    got = tw.search(q)   # method=None → "sharded"
    assert tw.t._shard_view is not None and tw.t._dev_f32 is not None
    assert [[h.id for h in r] for r in got] == \
        [[h.id for h in r] for r in want]


@pytest.mark.parametrize("tier", ["sharded_exact", "sharded_bf16",
                                  "sharded_int8", "sharded_int4"])
def test_sharded_tiers_through_store_api_match_jax(tier):
    rng = np.random.default_rng(1)
    tw, ids, vecs = _twin(rng)
    tw.attach()
    q = vecs[[17, 40]] + 0.01 * rng.normal(size=(2, DIM)).astype(np.float32)
    # The bf16 tier rounds the operands, not the f32 sums: the two stacks
    # add the same bf16 products in another order.
    got = tw.search(q, method=tier, tol=1e-5 if tier == "sharded_bf16"
                    else TOL)
    assert [r[0].id for r in got] == ["id17", "id40"]


def test_sharded_requires_mesh_and_a_gallery_axis():
    rng = np.random.default_rng(2)
    tw, *_ = _twin(rng, 40)
    for g in (tw.j, tw.t):
        with pytest.raises(ValueError, match="attach_mesh"):
            g.search(np.zeros(DIM, np.float32), method="sharded")
    from retrieval_based_object_detection_tpu.parallel.mesh import (
        make_mesh as jmake_mesh,
    )

    with pytest.raises(ValueError, match="gallery"):
        tw.j.attach_mesh(jmake_mesh({"dp": 2, "tp": 4}))
    with pytest.raises(ValueError, match="gallery"):
        tw.t.attach_mesh(make_mesh({"dp": 2, "tp": 4}, ["cpu"] * 8))


def test_filtered_sharded_search_and_mask_cache():
    rng = np.random.default_rng(3)
    tw, ids, vecs = _twin(rng)
    tw.attach()
    q = rng.normal(size=DIM).astype(np.float32)
    got = tw.search(q, flt={"class_name": "a"})
    assert all(h.payload.class_name == "a" for h in got[0])
    key = tschema.Filter(must={"class_name": "a"}).cache_key()
    cached = tw.t._shard_mask_cache[key]
    tw.search(q, flt={"class_name": "a"})
    assert tw.t._shard_mask_cache[key] is cached
    nid, nv, npl = _mk(rng, 1, start=9000, cls="a")
    tw.upsert(nid, nv, npl)
    assert key not in tw.t._shard_mask_cache
    assert tw.search(nv[0], k=1, flt={"class_name": "a"})[0][0].id == \
        "id9000"


def test_interleaved_writes_deletes_patch_the_view():
    """Writes and deletes through the store API patch the sharded view
    (the view object survives) and every read equals JAX's."""
    rng = np.random.default_rng(4)
    tw, ids, vecs = _twin(rng, 300)
    tw.attach()
    assert tw.search(vecs[7], k=1)[0][0].id == "id7"
    view = tw.t._shard_view
    tw.upsert(["id7"], -vecs[7][None],
              [dict(data_type="original_images", class_name="b",
                    img_path="/t/new7.png")])
    assert tw.search(-vecs[7], k=1)[0][0].payload.img_path == "/t/new7.png"
    tw.delete(ids=["id12"])
    assert all(h.id != "id12" for h in tw.search(vecs[12], k=3)[0])
    aid, av, apl = _mk(rng, 5, start=500, cls="a")
    tw.upsert(aid, av, apl)
    assert tw.search(av[2], k=1)[0][0].id == "id502"
    tw.upsert(["id12"], vecs[12][None],
              [dict(data_type="original_images", class_name="a",
                    img_path="/t/12.png")])
    assert tw.search(vecs[12], k=1)[0][0].id == "id12"
    assert tw.t._shard_view is view
    q = rng.normal(size=(4, DIM)).astype(np.float32)
    tw.search(q, k=6, method="sharded_exact")
    tw.search(q, k=6, method="exact")


def test_tombstones_do_not_revive_inside_patched_runs():
    rng = np.random.default_rng(5)
    tw, ids, vecs = _twin(rng, 100)
    tw.attach()
    tw.search(vecs[0], k=1)
    tw.delete(ids=["id50"])
    tw.upsert(["id49", "id51"], vecs[[49, 51]],
              [dict(data_type="original_images", class_name="a",
                    img_path=f"/t/{i}.png") for i in (49, 51)])
    assert all(h.id != "id50" for h in tw.search(vecs[50], k=5)[0])


def test_headroom_overflow_rebuilds_once():
    rng = np.random.default_rng(6)
    tw, ids, vecs = _twin(rng, 64)
    tw.attach()
    tw.search(vecs[0], k=1)
    view = tw.t._shard_view
    assert view.total == tw.j._shard_view.dev_vectors.shape[0]
    aid, av, apl = _mk(rng, view.total - 64 + 10, start=1000, cls="a")
    tw.upsert(aid, av, apl)
    assert tw.search(av[-1], k=1)[0][0].id == aid[-1]
    assert tw.t._shard_view is not view


def test_compaction_rebuilds_the_view(monkeypatch):
    for cls in (JGallery, TGallery):
        monkeypatch.setattr(cls, "_COMPACT_DEAD_MIN", 8)
    rng = np.random.default_rng(8)
    tw, ids, vecs = _twin(rng, 200)
    tw.attach()
    tw.search(vecs[0], k=1)
    tw.delete(ids=[f"id{i}" for i in range(0, 120, 2)])
    assert tw.t._compact_due and tw.j._compact_due
    assert tw.j.maintain() == tw.t.maintain()
    q = rng.normal(size=(2, DIM)).astype(np.float32)
    tw.search(q, k=5)


def test_store_level_mesh_config():
    rng = np.random.default_rng(9)
    ids, vecs, pls = _mk(rng, 60)
    js, ts = JStore(), TStore(device="cpu")
    for store, P in ((js, jschema.Payload), (ts, tschema.Payload)):
        store.create_collection("one", dim=DIM).upsert(
            ids, vecs, [P(**p) for p in pls])
    assert js.attach_mesh(jgallery_mesh(8)) == \
        ts.attach_mesh(gallery_mesh(8, device="cpu")) == 1
    g1 = ts.get("one")
    assert g1.search(vecs[3], k=1)[0][0].id == "id3"
    assert g1._shard_view is not None
    g2 = ts.create_collection("two", dim=DIM)
    g2.upsert(ids, vecs, [tschema.Payload(**p) for p in pls])
    assert g2.search(vecs[5], k=1)[0][0].id == "id5"
    assert g2._shard_view is not None
    ts.detach_mesh()
    assert g1._gallery_mesh is None and g2._gallery_mesh is None


def test_view_id_keyed_writes_match_jax():
    rng = np.random.default_rng(10)
    tw, ids, vecs = _twin(rng, 120)
    jv = jsh.ShardedGallerySearcher.from_gallery(tw.j, jgallery_mesh(8),
                                                 headroom=64)
    tv = tsh.ShardedGallerySearcher.from_gallery(tw.t, _tmesh(8),
                                                 headroom=64)
    newv = rng.normal(size=(2, DIM)).astype(np.float32)
    assert jv.upsert(["id10", "fresh"], newv) == \
        tv.upsert(["id10", "fresh"], newv) == 2
    assert jv.delete(["id10", "missing"]) == tv.delete(["id10", "missing"])
    q = np.concatenate([newv, vecs[:3]])
    js, ji = jv.search(q, k=4)
    ts, ti = tv.search(q, k=4)
    _assert_topk(js, ji, ts, ti)
    assert tv.ids_of(ti) == jv.ids_of(ji)
    assert tv.ids_of(ti)[1][0] == "fresh" and tv.ids_of(ti)[0][0] != "id10"


def test_capacity_scale_exact_raises_not_degrades(monkeypatch):
    for cls in (JGallery, TGallery):
        monkeypatch.setattr(cls, "CAPACITY_AUTO_BYTES", 1)
    rng = np.random.default_rng(11)
    tw, ids, vecs = _twin(rng)
    tw.attach()
    for g in (tw.j, tw.t):
        with pytest.raises(ValueError, match="exact search is unavailable"):
            g.search(vecs[3], k=5)
    assert tw.t._shard_view.capacity
    # Both rescore against bf16 rows.
    assert tw.search(vecs[3], exact=False, tol=1e-5)[0][0].id == "id3"
    assert tw.search(vecs[3], method="sharded_int4",
                     tol=1e-5)[0][0].id == "id3"


def test_attach_mesh_drops_a_live_capacity_view():
    """(Off a TPU JAX's capacity tier rescores through its CPU twin, so
    its capacity hits are not compared; the sharded ones are.)"""
    rng = np.random.default_rng(12)
    tw, ids, vecs = _twin(rng)
    q = rng.normal(size=(2, DIM)).astype(np.float32)
    tw.t.search(q, exact=False, method="capacity")
    assert tw.t._cap_view is not None
    tw.attach()
    assert tw.t._cap_view is None and not tw.t._cap_pending
    nids, nvecs, npls = _mk(rng, 8, start=1000)
    tw.upsert(nids, nvecs, npls)
    tw.delete(ids=[ids[0]])
    assert not tw.t._cap_pending
    tw.search(q)
    assert tw.t.search(q, exact=False, method="capacity")[0]
    assert tw.t._cap_view is not None


def test_random_ops_match_jax():
    """Random upserts, deletes and filtered searches with the mesh
    attached: every sharded read equals JAX's, and no tombstone comes
    back."""
    rng = np.random.default_rng(13)
    tw = Twin("fuzz")
    ids0, vecs0, pls0 = _mk(rng, 300)
    tw.upsert(ids0, vecs0, pls0)
    tw.attach()
    tw.search(rng.normal(size=DIM).astype(np.float32), k=1)
    view = tw.t._shard_view
    live, next_id = set(ids0), 1000
    for step in range(25):
        op = int(rng.integers(0, 3))
        if op == 0:
            ids = []
            for _ in range(int(rng.integers(1, 5))):
                if rng.random() < 0.5:
                    ids.append(sorted(live)[int(rng.integers(0, len(live)))])
                else:
                    ids.append(f"id{next_id}")
                    next_id += 1
            ids = list(dict.fromkeys(ids))
            tw.upsert(ids, rng.normal(size=(len(ids), DIM)).astype(
                np.float32), [dict(data_type="original_images",
                                   class_name="a" if i % 2 else "b",
                                   img_path=f"/f/{pid}.png")
                              for i, pid in enumerate(ids)])
            live.update(ids)
        elif op == 1 and len(live) > 5:
            victims = [sorted(live)[int(i)]
                       for i in rng.integers(0, len(live), size=2)]
            tw.delete(ids=victims)
            live.difference_update(victims)
        else:
            target = sorted(live)[int(rng.integers(0, len(live)))]
            q = tw.t._vectors[tw.t._id_to_row[target]] + 0.001 * \
                rng.normal(size=DIM).astype(np.float32)
            sh = tw.search(q, k=3)[0]
            assert sh[0].id == target and all(h.id in live for h in sh)
            fh = tw.search(q, k=5, flt={"class_name": "a"})[0]
            assert all(h.payload.class_name == "a" and h.id in live
                       for h in fh)
    assert tw.t._shard_view is view


def test_capacity_chunked_build_matches_direct_planes():
    """The per-shard chunked capacity build equals planes packed from the
    whole normalised array at once, bit for bit, and its bf16 rows equal
    JAX's."""
    rng = np.random.default_rng(14)
    n = 700
    vecs = rng.normal(size=(n, DIM)).astype(np.float32)
    mask = np.ones(n, bool)
    tv = tsh.ShardedGallerySearcher(vecs, mask, _tmesh(8), capacity=True)
    jv = jsh.ShardedGallerySearcher(vecs, mask, jgallery_mesh(8),
                                    capacity=True)
    raw = torch.zeros((tv.total, DIM))
    raw[:n] = torch.from_numpy(vecs)
    full = raw / torch.clamp(torch.linalg.vector_norm(raw, dim=1,
                                                      keepdim=True), min=1e-12)
    want_p, want_s = tsearch.pack_rows_int4(full)
    got_p = torch.cat([p for p, _ in tv._dev_int4])
    got_s = torch.cat([s for _, s in tv._dev_int4])
    got_b = torch.cat(tv.dev_vectors)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_p.numpy(), want_p.numpy())
    np.testing.assert_array_equal(got_s.numpy(), want_s.numpy())
    np.testing.assert_array_equal(
        got_b.float().numpy(), full.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(
        got_b.float().numpy(), np.asarray(jv.dev_vectors, np.float32))
