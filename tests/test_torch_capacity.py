"""Port parity: the capacity tier (int4 planes + bf16 rescore mirror).

The port's ``CapacitySearcher`` and ``Gallery.search(method="capacity")``
against the JAX package's, on the same numpy-seeded rows. The JAX view
calls its int4 kernel only on a TPU and an unpack-and-dot twin elsewhere;
the port calls its scan (kernel B3 on CUDA, the plain version here) on
every device. So the JAX side is run as on a TPU: ``platform.is_tpu`` is
patched true and its scans run in Pallas interpret mode. Scores are held
to JAX's at 1e-6, hit sets exactly. Oracles: tests/test_capacity.py,
test_capacity_tier.py, test_capacity_planes.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.gallery import capacity as jcap
from retrieval_based_object_detection_tpu.gallery import persist as jpersist
from retrieval_based_object_detection_tpu.gallery import planes as jplanes
from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery import search as jsearch
from retrieval_based_object_detection_tpu.gallery.store import Gallery as JGallery
from retrieval_based_object_detection_tpu.utils import platform as jplatform
from retrieval_based_object_detection_tpu_torch.gallery import capacity as tcap
from retrieval_based_object_detection_tpu_torch.gallery import persist as tpersist
from retrieval_based_object_detection_tpu_torch.gallery import planes as tplanes
from retrieval_based_object_detection_tpu_torch.gallery import schema as tschema
from retrieval_based_object_detection_tpu_torch.gallery import search as tsearch
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
)
from retrieval_based_object_detection_tpu_torch.ops.int4_scan import unpack_int4

DIM = 64
ATOL = 1e-6


@pytest.fixture
def jax_as_on_tpu(monkeypatch):
    """The JAX capacity/int4/int8 code paths a TPU takes, with the Pallas
    scans interpreted on the CPU."""
    monkeypatch.setattr(jplatform, "is_tpu", lambda: True)
    for name in ("int4_scan_topk", "int8_scan_topk"):
        monkeypatch.setattr(jsearch, name, functools.partial(
            getattr(jsearch, name), interpret=True))


def _rows(seed, n, d=DIM):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _bits(t):
    """A bf16 plane (JAX array or torch tensor) as uint16 patterns."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _close_codes(a, b):
    """Integer planes (bf16 bit patterns, unpacked int4 codes) at most one
    step apart, in under 0.1% of places."""
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


def _same_planes(jv, tv):
    """Device-built planes agree to one step of their rounding: bf16 rows
    and int4 codes at most 1 apart (in under 0.1% of places), scales to
    one bf16 step (a scale is the largest |value| of a row / 7). Each package normalises on its device with f32 norms and
    quotients that XLA's fusions round in their own way (a few ulps of a
    row, which a bf16 or int4 rounding carries now and then, most of all
    when an edge tile re-packs rows from their bf16 values), and JAX's
    jitted build multiplies by the f32 reciprocal of 7 where eager JAX,
    its host planes and the port divide by 7. The host planes of a sidecar
    are bit for bit (below)."""
    _close_codes(_bits(tv.dev_bf16), _bits(jv.dev_bf16))
    _close_codes(unpack_int4(tv.dev_packed).numpy(),
                 unpack_int4(torch.tensor(np.asarray(jv.dev_packed))))
    np.testing.assert_allclose(tv.dev_scales.numpy(),
                               np.asarray(jv.dev_scales), rtol=2 ** -8)
    np.testing.assert_array_equal(tv._host_mask, jv._host_mask)


def _same_hits(j, t):
    (js, ji), (ts, ti) = j, t
    np.testing.assert_allclose(ts, js, atol=ATOL)
    for a, b in zip(ti, ji):
        assert set(a.tolist()) == set(b.tolist())


def test_bf16_rescore_keeps_f32_scores(jax_as_on_tpu):
    """With the capacity tier's bf16 rows the rescore rounds the query to
    bf16 and multiplies the bf16 values with f32 scores, as JAX's
    int4_scan_topk does (``preferred_element_type=jnp.float32``); a torch
    bf16 einsum would round the scores themselves to bf16."""
    n = 1024  # the Pallas scan tiles rows by 256
    rows = _rows(0, n)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = _rows(1, 6) + 2.0 * rows[:6]
    mask = np.random.default_rng(2).random(n) > 0.1
    jp, jsc = jsearch.pack_rows_int4(jnp.asarray(rows))
    js, ji = jsearch.int4_scan_topk(
        jnp.asarray(q), jp, jsc, jnp.asarray(rows).astype(jnp.bfloat16),
        jnp.asarray(mask), k=10, rescore=64)
    tp, tsc = tsearch.pack_rows_int4(torch.from_numpy(rows))
    tb = torch.from_numpy(rows).to(torch.bfloat16)
    for fn in (tsearch.int4_scan_topk, tsearch.int4_cosine_topk):
        ts, ti = fn(torch.from_numpy(q), tp, tsc, tb,
                    torch.from_numpy(mask), k=10, rescore=64)
        assert ts.dtype == torch.float32
        _same_hits((np.asarray(js), np.asarray(ji)),
                   (ts.numpy(), ti.numpy()))


@pytest.mark.parametrize("chunk,headroom", [(512, 0), (256, 300),
                                            (1 << 18, 4096)])
def test_build_matches_jax_planes_and_search(chunk, headroom, jax_as_on_tpu):
    n = 2000
    v = _rows(3, n)
    mask = np.random.default_rng(4).random(n) > 0.1
    jv = jcap.CapacitySearcher(v, mask, chunk=chunk, headroom=headroom)
    tv = tcap.CapacitySearcher(v, mask, chunk=chunk, headroom=headroom,
                               device="cpu")
    assert tv._padded == jv._padded and tv._tile == jv._tile
    _same_planes(jv, tv)
    q = v[:5] + 0.2 * _rows(5, 5)
    extra = np.random.default_rng(6).random(n) > 0.3
    for em in (None, extra, extra[: n // 2]):
        _same_hits(jv.search(q, k=10, extra_mask=em),
                   tv.search(q, k=10, extra_mask=em))
    dev = np.zeros(tv._padded, bool)
    dev[:n] = extra
    _same_hits(jv.search(q, k=10, extra_mask=jnp.asarray(dev)),
               tv.search(q, k=10, extra_mask=torch.from_numpy(dev)))


def test_incremental_writes_match_jax(jax_as_on_tpu):
    """Overwrites with partial edge tiles, appends into headroom, id-keyed
    upserts of scattered and new ids, deletes: the same planes, mask and
    hits as the JAX view after each."""
    n = 1500
    v = _rows(7, n)
    ids = [f"p{i}" for i in range(n)]
    jv = jcap.CapacitySearcher(v, np.ones(n, bool), chunk=512, ids=list(ids),
                               headroom=600)
    tv = tcap.CapacitySearcher(v, np.ones(n, bool), chunk=512,
                               ids=list(ids), headroom=600, device="cpu")
    q = _rows(8, 4)
    w = _rows(9, 700)
    steps = [
        lambda s: s.upsert_rows(100, w[:300]),           # spans 3 tiles
        lambda s: s.upsert_rows(n, w[300:500]),           # append
        lambda s: s.upsert(["p5", "new1", "p900", "new2"], w[500:504]),
        lambda s: s.delete(["p5", "p6", "nope"]),
        lambda s: s.set_rows_invalid([0, 1, 1, 10_000]),
    ]
    for step in steps:
        assert step(jv) == step(tv)
        assert tv.n_rows == jv.n_rows and tv.ids == jv.ids
        _same_planes(jv, tv)
        _same_hits(jv.search(q, k=8), tv.search(q, k=8))
    for view in (jv, tv):
        with pytest.raises(ValueError, match="exceed"):
            view.upsert([f"x{i}" for i in range(900)], _rows(14, 900))
    assert tv.ids == jv.ids and tv.capacity_left() == jv.capacity_left()
    assert tv.ids_of(np.array([[0, 5, 10 ** 6]])) == \
        jv.ids_of(np.array([[0, 5, 10 ** 6]]))


def test_sidecar_planes_are_jax_bytes_and_restore_the_same_view(tmp_path):
    """The host planes of a sidecar are bit for bit JAX's (no ml_dtypes in
    the port), and a view restored from them holds those exact planes."""
    n = 1200
    v = _rows(10, n)
    jb, jpk, js = jplanes.host_pack_planes(v)
    tb, tpk, ts = tplanes.host_pack_planes(v)
    np.testing.assert_array_equal(tb, jb.view(np.uint16))
    np.testing.assert_array_equal(tpk, jpk)
    np.testing.assert_array_equal(ts, js)
    mask = np.ones(n, bool)
    jv = jcap.CapacitySearcher.from_host_planes(jb, jpk, js, mask, n,
                                                headroom=100)
    tv = tcap.CapacitySearcher.from_host_planes(tb, tpk, ts, mask, n,
                                                headroom=100, device="cpu")
    np.testing.assert_array_equal(_bits(tv.dev_bf16), _bits(jv.dev_bf16))
    np.testing.assert_array_equal(tv.dev_packed.numpy(),
                                  np.asarray(jv.dev_packed))
    np.testing.assert_array_equal(tv.dev_scales.numpy(),
                                  np.asarray(jv.dev_scales))


def test_from_device_planes_checks_rows_and_pads_the_mask():
    n, d = 300, 8
    b = torch.zeros((n, d), dtype=torch.bfloat16)
    p = torch.zeros((n, d // 2), dtype=torch.int8)
    s = torch.zeros(n)
    with pytest.raises(ValueError, match="multiple of 256"):
        tcap.CapacitySearcher.from_device_planes(b, p, s, np.ones(n, bool),
                                                 n)
    view = tcap.CapacitySearcher.from_device_planes(
        b[:256], p[:256], s[:256], torch.ones(100, dtype=torch.bool), 100)
    assert view._host_mask.sum() == 100 and view.dev_mask.shape == (256,)
    with pytest.raises(ValueError, match="even dim"):
        tcap.CapacitySearcher(np.ones((4, 3), np.float32), np.ones(4, bool),
                              device="cpu")


def _twin(n=800, seed=11):
    v = _rows(seed, n)
    out = []
    for mod, g in ((jschema, JGallery("cap", dim=DIM)),
                   (tschema, TGallery("cap", dim=DIM, device="cpu"))):
        g.upsert([f"p{i}" for i in range(n)], v,
                 [mod.Payload(data_type="original_images",
                              class_name=f"c{i % 4}", img_path=f"/c/{i}.png")
                  for i in range(n)])
        out.append((mod, g))
    return out, v


def _gallery_hits_agree(jres, tres):
    for a, b in zip(jres, tres):
        assert {h.id for h in a} == {h.id for h in b}
        np.testing.assert_allclose(sorted(h.score for h in b),
                                   sorted(h.score for h in a), atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_gallery_capacity_search_tracks_writes_like_jax(seed, jax_as_on_tpu):
    """method="capacity" through the store: writes and deletes after the
    view is built reach it through the pending-op log (no tombstone comes
    back), filters through the cached masks, in step with the JAX store."""
    ((jm, jg), (tm, tg)), v = _twin(seed=seed)
    rng = np.random.default_rng(seed)
    q = v[:4] + 0.1 * _rows(12, 4)

    def search(flt=None):
        _gallery_hits_agree(
            jg.search(q, k=6, method="capacity",
                      flt=None if flt is None else jm.Filter(must=flt)),
            tg.search(q, k=6, method="capacity",
                      flt=None if flt is None else tm.Filter(must=flt)))

    search()
    view = tg._cap_view
    for step in range(4):
        new = rng.normal(size=(3, DIM)).astype(np.float32)
        pid = [f"p{int(rng.integers(0, 800))}", f"n{seed}{step}", "p1"]
        for mod, g in ((jm, jg), (tm, tg)):
            g.upsert(pid, new, [mod.Payload(
                data_type="original_images", class_name="c0",
                img_path=f"/n/{step}{i}.png") for i in range(3)])
            g.delete(ids=[f"p{int(i)}" for i in
                          np.random.default_rng(step).integers(0, 800, 5)])
            g.delete(ids=["p1"])
        search()
        search({"class_name": "c0"})
        assert tg._cap_view is view  # patched, never rebuilt
        assert not any(h.id == "p1" for r in tg.search(
            q, k=20, method="capacity") for h in r)


def test_gallery_capacity_headroom_overflow_rebuilds(jax_as_on_tpu,
                                                     monkeypatch):
    """Appends past the view's headroom rebuild it once (chunks shrunk so
    the headroom is 4,096 rows at this size)."""
    for mod in (jcap, tcap):
        monkeypatch.setattr(mod, "_CHUNK", 256)
    ((jm, jg), (tm, tg)), v = _twin(n=300)
    q = v[:2]
    _gallery_hits_agree(jg.search(q, k=3, method="capacity"),
                        tg.search(q, k=3, method="capacity"))
    view = tg._cap_view
    more = _rows(13, 5000)
    for mod, g in ((jm, jg), (tm, tg)):
        g.upsert([f"m{i}" for i in range(5000)], more,
                 [mod.Payload(data_type="o", class_name="m")] * 5000)
    _gallery_hits_agree(jg.search(more[:2], k=3, method="capacity"),
                        tg.search(more[:2], k=3, method="capacity"))
    assert tg._cap_view is not view


def test_restart_restores_the_view_from_the_sidecar(tmp_path, monkeypatch):
    """A load with a matching sidecar builds the capacity view from the
    host planes (no f32 upload, no device quantise); a later write makes
    the sidecar stale and the view is built from the rows."""
    ((_, jg), (tm, tg)), v = _twin(n=600)
    tpersist.save_gallery(tg, tmp_path)
    tpersist.save_capacity_planes(tg, tmp_path)
    g2 = tpersist.load_gallery("cap", tmp_path, device="cpu")
    built = []
    real = tcap.CapacitySearcher.__init__
    monkeypatch.setattr(tcap.CapacitySearcher, "__init__",
                        lambda self, *a, **kw: (built.append(1),
                                                real(self, *a, **kw))[1])
    q = v[:3]
    tg._planes_path = None  # the live gallery builds from its rows
    fresh = tg.search(q, k=5, method="capacity")
    assert built == [1]
    restored = g2.search(q, k=5, method="capacity")
    assert built == [1]  # the sidecar view: no constructor call
    for a, b in zip(fresh, restored):
        assert [(h.id, h.score) for h in a] == [(h.id, h.score) for h in b]
    g3 = tpersist.load_gallery("cap", tmp_path, device="cpu")
    g3.upsert(["zz"], v[:1], [tm.Payload(data_type="o", class_name="z")])
    g3.search(q, k=5, method="capacity")
    assert built == [1, 1]
    # The JAX store restores the same sidecar file.
    jg2 = jpersist.load_gallery("cap", tmp_path)
    assert jg2._planes_path == g2._planes_path
