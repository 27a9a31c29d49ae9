"""Port parity: tombstone deletes, compaction and the read paths after them.

The same write / delete / compact sequences, from numpy-seeded vectors and
payloads, run on the JAX package's Gallery and on the port's (on the CPU).
Every read path — count, scroll, scroll_all, retrieve, get_by_path (exact
and resolved), distinct, vectors_matching and each search tier (exact,
bf16, int8, int4) — must agree after every step: host results exactly,
search hits as id sets with scores to 1e-5 (the same f32 math summed in
another order). Oracles: tests/test_tombstones.py, test_store_mirrors.py,
test_edge_cases.py, test_gallery.py.
"""

import os

import numpy as np
import pytest

from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery.store import Gallery as JGallery
from retrieval_based_object_detection_tpu_torch.gallery import schema as tschema
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
)

DIM = 16
TIERS = ("exact", "bf16", "int8", "int4")


def _mk(mod, rng, n, start=0, dim=DIM):
    ids = [f"id{start + i}" for i in range(n)]
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    pls = [mod.Payload(data_type="original_images",
                       class_name="a" if (start + i) % 2 else "b",
                       img_path=f"/t/{start + i}.png",
                       is_augmented=(start + i) % 3 == 0)
           for i in range(n)]
    return ids, vecs, pls


class Twin:
    """One JAX gallery and one port gallery, driven alike."""

    def __init__(self, name="twin", dim=DIM, **kw):
        self.j = JGallery(name, dim=dim, **kw)
        self.t = TGallery(name, dim=dim, device="cpu", **kw)

    def upsert(self, seed, n, start=0):
        for mod, g in ((jschema, self.j), (tschema, self.t)):
            g.upsert(*_mk(mod, np.random.default_rng(seed), n, start,
                          g.dim))

    def delete(self, ids=None, flt=None):
        r = [g.delete(ids=ids, flt=None if flt is None else mod.Filter(**flt))
             for mod, g in ((jschema, self.j), (tschema, self.t))]
        assert r[0] == r[1]
        return r[1]

    def both(self, name, *a, **kw):
        r = [getattr(g, name)(*a, **kw) for g in (self.j, self.t)]
        assert r[0] == r[1], name
        return r[1]


def _rec(r, vectors=False):
    out = (r.id, r.payload.to_dict())
    return out + (r.vector.tolist(),) if vectors else out


FILTERS = [None, dict(must={"class_name": "a"}),
           dict(must={"is_augmented": True}, must_not={"class_name": "b"}),
           dict(must={"img_path": "/t/5.png"})]


def _hits_agree(jres, tres):
    assert len(jres) == len(tres)
    for jh, th in zip(jres, tres):
        assert {h.id for h in th} == {h.id for h in jh}
        np.testing.assert_allclose(sorted(h.score for h in th),
                                   sorted(h.score for h in jh), atol=1e-5)


def check(tw: Twin, queries=None, tiers=TIERS, k=5):
    """Every read path of the two galleries agrees."""
    j, t = tw.j, tw.t
    assert len(t) == len(j) and t._n_dead == j._n_dead
    assert t._nrows == j._nrows and t.write_seq == j.write_seq
    for spec in FILTERS:
        jf = None if spec is None else jschema.Filter(**spec)
        tf = None if spec is None else tschema.Filter(**spec)
        assert t.count(tf) == j.count(jf)
        assert [_rec(r, True) for r in t.scroll_all(tf, True)] == \
            [_rec(r, True) for r in j.scroll_all(jf, True)]
        jp, jn = j.scroll(jf, limit=3, offset=1)
        tp, tn = t.scroll(tf, limit=3, offset=1)
        assert [_rec(r) for r in tp] == [_rec(r) for r in jp] and tn == jn
        np.testing.assert_array_equal(t.vectors_matching(tf),
                                      j.vectors_matching(jf))
        for fld in ("class_name", "data_type"):
            assert t.distinct(fld, tf) == j.distinct(fld, jf)
    probe = [f"id{i}" for i in range(0, 60, 3)] + ["nope"]
    assert [_rec(r, True) for r in t.retrieve(probe)] == \
        [_rec(r, True) for r in j.retrieve(probe)]
    for i in range(0, 60, 7):
        for path in (f"/t/{i}.png", f"/t/x/../{i}.png"):
            jr, tr = j.get_by_path(path), t.get_by_path(path)
            assert (tr is None) == (jr is None)
            if tr is not None:
                assert _rec(tr, True) == _rec(jr, True)
    if queries is not None and len(t):
        for method in tiers:
            for spec in FILTERS[:3]:
                jf = None if spec is None else jschema.Filter(**spec)
                tf = None if spec is None else tschema.Filter(**spec)
                _hits_agree(j.search(queries, k=k, flt=jf, method=method),
                            t.search(queries, k=k, flt=tf, method=method))


@pytest.fixture
def queries():
    return np.random.default_rng(99).normal(size=(3, DIM)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_deletes_match_jax_on_every_read_path(seed, queries,
                                                     monkeypatch):
    """Random interleavings of upserts, deletes by id and by filter,
    re-adds of deleted ids and compactions (the thresholds shrunk so they
    fire at this size, in both packages)."""
    for G in (JGallery, TGallery):
        monkeypatch.setattr(G, "_COMPACT_DEAD_MIN", 6)
    rng = np.random.default_rng(seed)
    tw = Twin(capacity=16)
    tw.upsert(seed, 40)
    check(tw, queries)
    for step in range(6):
        op = int(rng.integers(0, 4))
        if op == 0:
            tw.delete(ids=[f"id{int(i)}" for i in rng.integers(0, 60, 4)])
        elif op == 1:
            tw.delete(flt=dict(must={"class_name": "a",
                                     "is_augmented": bool(step % 2)}))
        elif op == 2:  # overwrite + append, re-adding deleted ids
            tw.upsert(seed * 10 + step, 8, start=int(rng.integers(0, 52)))
        else:
            tw.both("compact")
        check(tw, queries)


def test_delete_keeps_every_device_mirror(queries):
    """A delete refreshes only the cached masks: each mirror tensor is the
    same object after it, and the deleted id leaves every tier at once."""
    tw = Twin()
    tw.upsert(1, 300)
    for method in TIERS:
        tw.t.search(queries, k=3, method=method)
    mirrors = (tw.t._dev_f32, tw.t._dev_bf16, tw.t._dev_int8,
               tw.t._dev_int4)
    target = tw.t.search(queries[:1], k=1)[0][0].id
    assert tw.delete(ids=[target]) == 1
    after = (tw.t._dev_f32, tw.t._dev_bf16, tw.t._dev_int8, tw.t._dev_int4)
    assert all(a is b for a, b in zip(after, mirrors))
    for method in TIERS:
        assert target not in {h.id for h in tw.t.search(
            queries[:1], k=5, method=method)[0]}
    check(tw, queries)


def test_delete_by_filter_then_reinsert_same_id(queries):
    tw = Twin()
    tw.upsert(2, 30)
    assert tw.delete(flt=dict(must={"class_name": "a"})) == 15
    v = np.random.default_rng(5).normal(size=(1, DIM)).astype(np.float32)
    for mod, g in ((jschema, tw.j), (tschema, tw.t)):
        g.upsert(["id1"], v, [mod.Payload(data_type="original_images",
                                          class_name="a",
                                          img_path="/t/new1.png")])
    assert tw.t.get_by_path("/t/new1.png").id == "id1"
    assert tw.t.search(v[0], k=1)[0][0].payload.img_path == "/t/new1.png"
    check(tw, queries)


@pytest.mark.parametrize("inline_max", [1 << 20, 40])
def test_compaction_inline_or_deferred_like_jax(inline_max, queries,
                                                monkeypatch, capsys):
    """Past the dead threshold a small gallery compacts inline; past
    _COMPACT_INLINE_MAX_ROWS the delete defers to maintain() and keeps
    serving off tombstones, mirrors untouched."""
    for G in (JGallery, TGallery):
        monkeypatch.setattr(G, "_COMPACT_DEAD_MIN", 8)
        monkeypatch.setattr(G, "_COMPACT_INLINE_MAX_ROWS", inline_max)
    tw = Twin()
    tw.upsert(3, 40)
    tw.t.search(queries, k=1)
    mirror = tw.t._dev_f32
    tw.delete(ids=[f"id{i}" for i in range(7)])
    assert tw.t._n_dead == 7
    tw.delete(ids=[f"id{i}" for i in range(7, 11)])
    deferred = inline_max == 40
    assert tw.t._compact_due == tw.j._compact_due == deferred
    assert (tw.t._dev_f32 is mirror) == deferred
    assert ("compaction deferred" in capsys.readouterr().err) == deferred
    check(tw, queries)
    assert tw.both("maintain") == (11 if deferred else 0)
    assert tw.both("maintain") == 0
    assert tw.t._nrows == 29
    check(tw, queries)


def test_delete_all_then_search_and_append(queries):
    tw = Twin()
    tw.upsert(4, 10)
    tw.t.search(queries, k=1)
    assert tw.delete(ids=[f"id{i}" for i in range(10)]) == 10
    assert tw.t.search(queries, k=3) == [[], [], []]
    assert tw.delete(ids=["id2"]) == 0  # idempotent
    tw.upsert(5, 5, start=100)
    check(tw, queries)


@pytest.mark.parametrize("how", ["delete", "overwrite"])
def test_resolved_duplicate_path_promotes(how, tmp_path):
    """Two live rows sharing one resolved path: deleting or re-pathing the
    index winner promotes the live duplicate, in both packages."""
    img = tmp_path / "shared.png"
    rel = os.path.relpath(str(img))
    vecs = np.random.default_rng(6).normal(size=(3, 8)).astype(np.float32)
    got = []
    for mod, g in ((jschema, JGallery("d", dim=8)),
                   (tschema, TGallery("d", dim=8, device="cpu"))):
        pl = [mod.Payload(data_type="o", class_name="c", img_path=p)
              for p in ("./" + rel, rel)]
        g.upsert(["a", "b"], vecs[:2], pl)
        seen = [g.get_by_path(str(img)).id]
        if how == "delete":
            g.delete(ids=["a"])
        else:
            g.upsert(["a"], vecs[2:], [mod.Payload(
                data_type="o", class_name="c", img_path="/elsewhere.png")])
        seen.append(g.get_by_path(str(img)).id)
        g.delete(ids=["b"])
        seen.append(g.get_by_path(str(img)))
        got.append(seen)
    assert got[0] == got[1] == ["a", "b", None]


def test_upsert_points_warm_and_array_roundtrip(queries):
    tw = Twin()
    rng = np.random.default_rng(7)
    vecs = rng.normal(size=(12, DIM)).astype(np.float32)
    for mod, g in ((jschema, tw.j), (tschema, tw.t)):
        g.upsert_points((f"id{i}", vecs[i], mod.Payload(
            data_type="original_images", class_name="a" if i % 2 else "b",
            img_path=f"/t/{i}.png")) for i in range(12))
    tw.delete(ids=["id3"])
    assert tw.t.warm(k=3, filters=[tschema.Filter(must={"class_name": "a"})]) >= 0
    assert tw.t._dev_f32 is not None and tw.t._dev_bf16 is not None
    check(tw, queries)
    ja, ta = tw.j.to_arrays(), tw.t.to_arrays()
    assert ta["ids"] == ja["ids"] and ta["payloads"] == ja["payloads"]
    np.testing.assert_array_equal(ta["vectors"], ja["vectors"])
    back = TGallery.from_arrays("back", ja, device="cpu")
    assert [_rec(r, True) for r in back.scroll_all(with_vectors=True)] == \
        [_rec(r, True) for r in tw.j.scroll_all(with_vectors=True)]


def test_payload_columns_clear_path_and_compact_match_jax():
    """The two PayloadColumns operations tombstones rely on."""
    cols = []
    for mod in (jschema, tschema):
        c = mod.PayloadColumns(8)
        c.set_rows(np.arange(6), [mod.Payload(
            data_type="o", class_name=f"c{i % 3}", img_path=f"/p/{i}")
            for i in range(6)])
        c.clear_path(2)
        new_rows = c.compact(np.array([1, 1, 0, 1, 0, 1], bool))
        cols.append((new_rows.tolist(), c.size,
                     [c.get_row(i).to_dict() for i in range(c.size)],
                     c.row_by_path("/p/3"), c.row_by_path("/p/2")))
    assert cols[0] == cols[1]
