"""Port parity: the non-cosine metrics and the full cosine score matrix.

``masked_metric_topk`` (dot, euclid, manhattan) and ``masked_cosine_scores``
of the port against the JAX package's, on the same numpy-seeded inputs, to
1e-5 relative; then galleries of each metric searched through both stores.
Oracle: tests/test_gallery.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery import search as jsearch
from retrieval_based_object_detection_tpu.gallery.store import Gallery as JGallery
from retrieval_based_object_detection_tpu_torch.gallery import schema as tschema
from retrieval_based_object_detection_tpu_torch.gallery import search as tsearch
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
)

RTOL = 1e-5


def _inputs(seed, n=1500, d=24, q=4):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n, d)) * rng.uniform(0.2, 3.0, (n, 1))
         ).astype(np.float32)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    mask = rng.random(n) > 0.2
    return qs, g, mask


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("distance", ["dot", "euclid", "manhattan"])
def test_masked_metric_topk_matches_jax(distance, exact):
    """n = 1,500 walks the manhattan chunks with a ragged last one."""
    qs, g, mask = _inputs(1)
    js, ji = jsearch.masked_metric_topk(
        jnp.asarray(qs), jnp.asarray(g), jnp.asarray(mask), k=7,
        distance=distance, exact=exact)
    ts, ti = tsearch.masked_metric_topk(
        torch.from_numpy(qs), torch.from_numpy(g), torch.from_numpy(mask),
        k=7, distance=distance, exact=exact)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=1e-6)
    for a, b in zip(ti.numpy(), np.asarray(ji)):
        assert set(a) == set(b)
    assert mask[ti.numpy()].all()


def test_metric_topk_bf16_gallery_rows():
    """The bf16 mirror of a metric gallery goes through the metric with
    its bf16 values (the exact=False tier)."""
    qs, g, mask = _inputs(2)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    js, _ = jsearch.masked_metric_topk(jnp.asarray(qs), gb,
                                       jnp.asarray(mask), k=5,
                                       distance="euclid", exact=False)
    ts, _ = tsearch.masked_metric_topk(
        torch.from_numpy(qs), torch.from_numpy(g).to(torch.bfloat16),
        torch.from_numpy(mask), k=5, distance="euclid", exact=False)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL)


def test_unknown_metric_raises():
    qs, g, mask = _inputs(3, n=8)
    with pytest.raises(ValueError, match="unsupported distance"):
        tsearch.masked_metric_topk(torch.from_numpy(qs), torch.from_numpy(g),
                                   torch.from_numpy(mask), k=2,
                                   distance="cosine")


@pytest.mark.parametrize("exact", [True, False])
def test_masked_cosine_scores_matches_jax(exact):
    qs, g, mask = _inputs(4, n=300)
    want = np.asarray(jsearch.masked_cosine_scores(
        jnp.asarray(qs), jnp.asarray(g), jnp.asarray(mask), exact=exact))
    got = tsearch.masked_cosine_scores(
        torch.from_numpy(qs), torch.from_numpy(g), torch.from_numpy(mask),
        exact=exact).numpy()
    assert (got[:, ~mask] == tsearch.NEG_INF).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def _twin(distance, seed=5, n=200, d=12):
    rng = np.random.default_rng(seed)
    vecs = (rng.normal(size=(n, d)) * 2.0).astype(np.float32)
    out = []
    for mod, G, kw in ((jschema, JGallery, {}),
                       (tschema, TGallery, {"device": "cpu"})):
        g = G("m", dim=d, distance=distance, **kw)
        g.upsert([f"p{i}" for i in range(n)], vecs,
                 [mod.Payload(data_type="original_images",
                              class_name=f"c{i % 3}") for i in range(n)])
        g.delete(ids=["p0", "p7"])
        out.append((mod, g))
    return out, vecs


@pytest.mark.parametrize("method", ["exact", "bf16"])
@pytest.mark.parametrize("distance", ["dot", "euclid", "manhattan"])
def test_metric_gallery_search_matches_jax(distance, method):
    """Raw rows in the mirrors (no normalisation), tombstones and filters
    honoured, scores to 1e-5 relative."""
    (jm, jg), (tm, tg) = _twin(distance)[0]
    q = np.random.default_rng(6).normal(size=(3, jg.dim)).astype(np.float32)
    for flt in (None, {"class_name": "c1"}):
        jf = None if flt is None else jm.Filter(must=flt)
        tf = None if flt is None else tm.Filter(must=flt)
        jres = jg.search(q, k=6, flt=jf, method=method)
        tres = tg.search(q, k=6, flt=tf, method=method)
        for a, b in zip(jres, tres):
            assert {h.id for h in a} == {h.id for h in b}
            assert not {"p0", "p7"} & {h.id for h in b}
            np.testing.assert_allclose(sorted(h.score for h in b),
                                       sorted(h.score for h in a),
                                       rtol=RTOL, atol=1e-6)


def test_metric_gallery_routes_and_refuses_quantised_tiers():
    """exact=False on a metric gallery auto-routes to bf16; the quantised
    tiers (unit-norm rows) raise, as in the JAX store."""
    (_, jg), (_, tg) = _twin("dot")[0]
    q = np.ones(tg.dim, np.float32)
    tg.search(q, exact=False)
    assert tg._dev_bf16 is not None and tg._dev_int8 is None
    for method in ("int8", "int4", "capacity"):
        for g in (jg, tg):
            with pytest.raises(ValueError, match="cosine"):
                g.search(q, method=method)
