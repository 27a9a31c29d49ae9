"""The port's gallery builds a read's Records in bulk.

``Gallery.search`` (every route ends in ``_rows_to_records``), ``scroll``,
``scroll_all``, ``retrieve`` and ``get_by_path`` read ids, payloads,
vectors and scores for all their rows at once (``PayloadColumns.get_rows``,
``Gallery._ids_at``). They must return the Records that the per-row
decode returns: ``_ref_*`` below keep that decode and its loop, and every
case compares the two on the same rows and scores (on the CPU).
"""

import dataclasses

import numpy as np
import pytest

from retrieval_based_object_detection_tpu_torch.gallery import persist
from retrieval_based_object_detection_tpu_torch.gallery import schema
from retrieval_based_object_detection_tpu_torch.gallery import search as search_lib
from retrieval_based_object_detection_tpu_torch.gallery.schema import (
    Filter,
    Payload,
)
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery,
    Record,
)

DIM = 16
N = 300
NEG_INF = search_lib.NEG_INF
DELEGATES = (None, "average", None, "medoid", "centroid", None)


# ------------------------------------------------------- per-row reference
def _ref_payload(cols, row: int) -> Payload:
    """One row's payload decoded field by field, through ``Payload``'s own
    constructor."""
    kw = {}
    for f in cols._CODED:
        code = int(cols._cols[f][row])
        kw[f] = cols._decode[f][code] if code >= 0 else None
    for f in schema.BOOL_FIELDS:
        kw[f] = bool(cols._cols[f][row])
    if cols._paths_lazy is not None:
        kw["img_path"] = cols._row_path_lazy(row) or ""
    else:
        kw["img_path"] = cols._img_path[row] or ""
    return Payload(**kw)


def _ref_id(g: Gallery, row: int) -> str:
    lst = g._ids_list
    if lst is not None:
        return lst[row]
    return g._ids_arr[row].decode("utf-8")


def _ref_record(g: Gallery, row: int, with_vectors: bool, score=None):
    return Record(id=_ref_id(g, row),
                  payload=_ref_payload(g._payloads, row),
                  vector=g._vectors[row].copy() if with_vectors else None,
                  score=score)


def _ref_hits(g: Gallery, scores, idx, k_eff: int, with_vectors: bool):
    """Per-query hits, a query's first NEG_INF score ending them."""
    results = []
    for qi in range(scores.shape[0]):
        hits = []
        for j in range(min(k_eff, scores.shape[1])):
            if scores[qi, j] <= NEG_INF / 2:
                break
            hits.append(_ref_record(g, int(idx[qi, j]), with_vectors,
                                    float(scores[qi, j])))
        results.append(hits)
    return results


def _key(r: Record) -> tuple:
    """Everything a caller can read off a Record, types included."""
    assert type(r) is Record and type(r.payload) is Payload
    vec = None if r.vector is None else (r.vector.dtype, r.vector.shape,
                                         r.vector.tobytes())
    return (r.id, r.payload, hash(r.payload), repr(r.payload),
            type(r.score), r.score, vec)


def _keys(hits) -> list:
    return [[_key(r) for r in per] for per in hits]


# ----------------------------------------------------------------- helpers
def _payload(i: int, cls: str | None = None) -> Payload:
    return Payload(
        data_type="natural_images" if i % 5 == 0 else "original_images",
        class_name=cls or f"c{i % 4}", img_path=f"/img/{i}.png",
        is_cropped=i % 3 != 0, is_segmented=bool(i % 2),
        is_augmented=i % 7 == 0,
        is_delegate=DELEGATES[i % len(DELEGATES)] is not None,
        delegate_type=DELEGATES[i % len(DELEGATES)])


def _gallery(name: str = "rec", n: int = N, seed: int = 0) -> Gallery:
    g = Gallery(name, dim=DIM, device="cpu")
    v = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    g.upsert([f"p{i:05d}" for i in range(n)], v,
             [_payload(i) for i in range(n)])
    return g


def _queries(g: Gallery, seed: int, q: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, g._nrows, q)
    return (g._vectors[rows]
            + 0.3 * rng.normal(size=(q, DIM))).astype(np.float32)


def _search_both(monkeypatch, g: Gallery, queries, **kw):
    """(the search's hits, the per-row reference's hits from the same top-k
    scores and rows)."""
    seen = []
    bulk = g._rows_to_records

    def spy(scores, idx, k_eff, with_vectors):
        seen.append((scores.copy(), idx.copy(), k_eff, with_vectors))
        return bulk(scores, idx, k_eff, with_vectors)

    monkeypatch.setattr(g, "_rows_to_records", spy)
    got = g.search(queries, **kw)
    monkeypatch.undo()
    assert len(seen) == 1
    return got, _ref_hits(g, *seen[0])


FILTERS = {
    "none": None,
    "class": Filter(must={"class_name": "c1"}),
    "delegates": Filter(must={"is_delegate": True}),
    "not_delegates": Filter(must_not={"is_delegate": True}),
}


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("method", ["exact", "bf16", "int8", "int4",
                                    "capacity"])
@pytest.mark.parametrize("flt", sorted(FILTERS))
def test_search_hits_equal_the_per_row_reference(monkeypatch, method, flt):
    g = _gallery()
    got, want = _search_both(monkeypatch, g, _queries(g, 1), k=10,
                             flt=FILTERS[flt], method=method)
    assert _keys(got) == _keys(want)
    assert all(len(per) == 10 for per in got)
    if flt == "delegates":  # None beside set values, decoded per row
        types = {h.payload.delegate_type for per in got for h in per}
        assert None not in types and types <= set(DELEGATES)
    if flt == "not_delegates":
        assert {h.payload.delegate_type for per in got for h in per} == {None}


@pytest.mark.parametrize("method", ["exact", "bf16"])
def test_search_with_tombstones(monkeypatch, method):
    g = _gallery()
    dead = [f"p{i:05d}" for i in range(0, N, 3)]
    assert g.delete(ids=dead) == len(dead)
    assert g._n_dead == len(dead)  # tombstoned, not compacted
    got, want = _search_both(monkeypatch, g, _queries(g, 2), k=12,
                             method=method)
    assert _keys(got) == _keys(want)
    assert not {h.id for per in got for h in per} & set(dead)
    recs, _ = g.scroll(limit=N)
    assert [_key(r) for r in recs] == [
        _key(_ref_record(g, int(r), False))
        for r in np.flatnonzero(g._alive[: g._nrows])]


@pytest.mark.parametrize("method", ["exact", "bf16", "int8"])
@pytest.mark.parametrize("k", [5, 30])
def test_k_past_the_filters_matches(monkeypatch, method, k):
    g = _gallery()
    g.upsert(["only0", "only1", "only2"],
             np.random.default_rng(3).normal(size=(3, DIM)).astype(np.float32),
             [_payload(i, cls="rare") for i in range(3)])
    got, want = _search_both(monkeypatch, g, _queries(g, 4, q=3), k=k,
                             flt=Filter(must={"class_name": "rare"}),
                             method=method)
    assert _keys(got) == _keys(want)
    assert [sorted(h.id for h in per) for per in got] == [
        ["only0", "only1", "only2"]] * 3


SCORE_ROWS = {
    "full": [0.9, 0.8, 0.7, 0.6, 0.5],
    "short": [0.9, 0.8, NEG_INF, NEG_INF, NEG_INF],
    "empty": [NEG_INF] * 5,
    # A finite score after a NEG_INF: the hits end at the first NEG_INF.
    "finite_after": [0.9, NEG_INF, 0.7, NEG_INF, 0.5],
    "minus_inf": [0.9, 0.8, -np.inf, 0.4, 0.3],
    "half_neg_inf": [0.9, NEG_INF / 2, 0.5, 0.4, 0.3],
}


@pytest.mark.parametrize("k_eff", [0, 2, 5, 9])
@pytest.mark.parametrize("with_vectors", [False, True])
def test_score_rows_end_at_their_first_neg_inf(k_eff, with_vectors):
    g = _gallery()
    scores = np.array(list(SCORE_ROWS.values()), np.float32)
    idx = np.random.default_rng(5).integers(0, N, scores.shape)
    got = g._rows_to_records(scores, idx, k_eff, with_vectors)
    assert _keys(got) == _keys(_ref_hits(g, scores, idx, k_eff,
                                         with_vectors))
    kept = min(k_eff, 5)
    lengths = dict(zip(SCORE_ROWS, map(len, got)))
    assert lengths == {"full": kept, "short": min(kept, 2), "empty": 0,
                       "finite_after": min(kept, 1),
                       "minus_inf": min(kept, 2),
                       "half_neg_inf": min(kept, 1)}


def test_score_is_a_python_float_of_the_f32_score():
    g = _gallery()
    scores = np.array([[np.float32(1) / 3, np.float32(0.1)]], np.float32)
    (hits,) = g._rows_to_records(scores, np.array([[4, 7]]), 2, False)
    assert [type(h.score) for h in hits] == [float, float]
    assert [h.score for h in hits] == [float(s) for s in scores[0]]


# ---------------------------------------------------- vectors stay copies
def _vector_reads(g: Gallery, monkeypatch):
    got, want = _search_both(monkeypatch, g, _queries(g, 6), k=4,
                             with_vectors=True)
    assert _keys(got) == _keys(want)
    yield "search", [h for per in got for h in per]
    yield "scroll", g.scroll(limit=7, offset=3, with_vectors=True)[0]
    yield "scroll_all", g.scroll_all(Filter(must={"class_name": "c2"}),
                                     with_vectors=True)
    yield "retrieve", g.retrieve(["p00009", "nope", "p00002", "p00009"])
    yield "get_by_path", [g.get_by_path("/img/11.png")]


@pytest.mark.parametrize("read", ["search", "scroll", "scroll_all",
                                  "retrieve", "get_by_path"])
def test_writing_a_returned_vector_leaves_the_store(monkeypatch, read):
    g = _gallery()
    before = g._vectors[: g._nrows].copy()
    recs = dict(_vector_reads(g, monkeypatch))[read]
    assert recs
    rows = [g._row_of(r.id) for r in recs]
    for r, row in zip(recs, rows):
        np.testing.assert_array_equal(r.vector, before[row])
        assert not np.shares_memory(r.vector, g._vectors)
    for r in recs:
        r.vector[:] = 7.0
    np.testing.assert_array_equal(g._vectors[: g._nrows], before)
    assert g.retrieve([recs[0].id])[0].vector.tobytes() == \
        before[rows[0]].tobytes()


# ----------------------------------------------------- the other reads
@pytest.mark.parametrize("with_vectors", [False, True])
@pytest.mark.parametrize("flt", sorted(FILTERS))
def test_scroll_all_and_pages_equal_the_per_row_reference(flt, with_vectors):
    g = _gallery()
    g.delete(ids=["p00004", "p00005"])
    rows = np.flatnonzero(g._mask_live(FILTERS[flt]))
    want = [_key(_ref_record(g, int(r), with_vectors)) for r in rows]
    assert [_key(r) for r in g.scroll_all(FILTERS[flt], with_vectors)] \
        == want
    pages, offset = [], 0
    while offset is not None:
        page, offset = g.scroll(FILTERS[flt], limit=17, offset=offset,
                                with_vectors=with_vectors)
        pages += page
    assert [_key(r) for r in pages] == want


@pytest.mark.parametrize("with_vectors", [False, True])
def test_retrieve_and_get_by_path_equal_the_per_row_reference(with_vectors):
    g = _gallery()
    g.delete(ids=["p00010"])
    ids = ["p00003", "missing", "p00010", "p00299", "p00003", "p00000"]
    want = [_key(_ref_record(g, g._row_of(i), with_vectors))
            for i in ids if g._row_of(i) is not None]
    assert [_key(r) for r in g.retrieve(ids, with_vectors)] == want
    assert g.retrieve([]) == []
    rec = g.get_by_path("/img/42.png", with_vectors)
    assert _key(rec) == _key(_ref_record(g, 42, with_vectors))
    assert g.get_by_path("/img/10.png") is None


# ------------------------------------------- a lazily loaded snapshot
def _lazy_pair(tmp_path):
    """A binary snapshot with a row-indexed delta, loaded lazily (mmap),
    and the gallery it was saved from."""
    g = _gallery("snap")
    persist.save_gallery(g, tmp_path)
    v = np.random.default_rng(9).normal(size=(3, DIM)).astype(np.float32)
    g.upsert(["p00017"], v[:1], [_payload(17, cls="over")])
    g.upsert(["appended"], v[1:2], [_payload(9000, cls="app")])
    g.delete(ids=["p00099", "p00042"])
    g.upsert(["p00042"], v[2:3], [_payload(42, cls="readd")])
    persist.save_gallery(g, tmp_path)
    lazy = persist.load_gallery("snap", tmp_path, mmap_vectors=True,
                                device="cpu")
    assert lazy._ids_list is None and lazy._id_map is None
    assert lazy._payloads._paths_lazy is not None
    assert lazy._payloads._pending_paths  # the delta's overlay writes
    return lazy, g


def _still_lazy(g: Gallery) -> bool:
    return (g._ids_list is None and g._id_map is None
            and g._payloads._paths_lazy is not None)


OVERLAY = Filter(should=(("class_name", "over"), ("class_name", "app"),
                         ("class_name", "readd")))


@pytest.mark.parametrize("flt", [None, OVERLAY])
@pytest.mark.parametrize("with_vectors", [False, True])
def test_lazy_snapshot_search_reads_rows_without_materialising(
        monkeypatch, tmp_path, flt, with_vectors):
    lazy, live = _lazy_pair(tmp_path)
    queries = np.concatenate([_queries(lazy, 8),
                              live._vectors[[17, N, N + 1]]])
    got, want = _search_both(monkeypatch, lazy, queries, k=6, flt=flt,
                             with_vectors=with_vectors)
    assert _still_lazy(lazy)
    assert _keys(got) == _keys(want)
    assert _keys(got) == _keys(live.search(queries, k=6, flt=flt,
                                           with_vectors=with_vectors))
    ids = {h.id for per in got for h in per}
    assert {"p00017", "appended", "p00042"} <= ids
    assert "p00099" not in ids
    paths = {h.id: h.payload.img_path for per in got for h in per}
    assert paths["appended"] == "/img/9000.png"  # past the blob: overlay
    assert paths["p00042"] == "/img/42.png"


def test_lazy_snapshot_reads_equal_the_live_gallery(tmp_path):
    lazy, live = _lazy_pair(tmp_path)
    ids = ["appended", "p00042", "p00099", "p00017", "p00001"]
    assert [_key(r) for r in lazy.retrieve(ids)] == \
        [_key(r) for r in live.retrieve(ids)]
    page, _ = lazy.scroll(OVERLAY, limit=10)
    assert [_key(r) for r in page] == \
        [_key(r) for r in live.scroll(OVERLAY, limit=10)[0]]
    assert _still_lazy(lazy)
    assert [_key(r) for r in lazy.scroll_all(with_vectors=True)] == \
        [_key(r) for r in live.scroll_all(with_vectors=True)]
    assert _still_lazy(lazy)


# ------------------------------------------------------------- payloads
def test_bulk_built_payload_is_an_ordinary_payload():
    vals = dict(data_type="natural_images", class_name="cola",
                img_path="/x.png", is_cropped=False, is_segmented=True,
                is_augmented=False, is_delegate=True, delegate_type="medoid")
    made = schema._payload_of(**vals)
    plain = Payload(**vals)
    assert type(made) is Payload
    assert made == plain and hash(made) == hash(plain)
    assert repr(made) == repr(plain) and made.to_dict() == plain.to_dict()
    assert dataclasses.astuple(made) == dataclasses.astuple(plain)
    assert made != dataclasses.replace(plain, delegate_type=None)
    with pytest.raises(dataclasses.FrozenInstanceError):
        made.class_name = "fanta"
    with pytest.raises(dataclasses.FrozenInstanceError):
        del made.img_path
    assert made.class_name == "cola"


@pytest.mark.parametrize("rows", [[], [7], [3, 3, 0, 299], [6, 5], "all"])
def test_get_rows_equals_get_row_and_the_reference(rows):
    cols = _gallery()._payloads
    cols.clear_path(5)
    for f in cols._CODED:  # code -1, a row never written, decodes to None
        cols._cols[f][6] = -1
    rows = list(range(N)) if rows == "all" else rows
    got = cols.get_rows(np.asarray(rows, np.int64))
    assert got == cols.get_rows(rows)
    want = [_ref_payload(cols, r) for r in rows]
    assert got == want and [hash(p) for p in got] == [hash(p) for p in want]
    assert [cols.get_row(r) for r in rows] == want
    if 5 in rows:
        assert got[rows.index(5)].img_path == ""
    if 6 in rows:
        p = got[rows.index(6)]
        assert (p.data_type, p.class_name, p.delegate_type) == (None,) * 3
