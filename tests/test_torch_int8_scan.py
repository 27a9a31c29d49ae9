"""Port parity: the int8 gallery scan (kernel B2) and its search wrappers
against the JAX package.

The JAX scan runs in Pallas interpret mode, as
tests/test_store_mirrors.py does. Integer scores are compared bit for bit;
top-k results by scores and id sets, since neither top-k promises an order
among ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.gallery import search as jsearch
from retrieval_based_object_detection_tpu.ops.int8_scan import (
    int8_scan_scores as jax_scan,
)
from retrieval_based_object_detection_tpu_torch.gallery import search as tsearch
from retrieval_based_object_detection_tpu_torch.ops import int8_scan as S


def _unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("Q,N,D", [(3, 512, 64), (16, 1024, 512),
                                   (5, 256, 1032)])
def test_plain_scores_bit_exact_vs_pallas_interpret(Q, N, D):
    rng = np.random.default_rng(Q + N)
    q = rng.integers(-127, 128, (Q, D), dtype=np.int8)
    g = rng.integers(-127, 128, (N, D), dtype=np.int8)
    pen = np.where(rng.random(N) < 0.2, jsearch.NEG_INF, 0.0).astype(np.float32)
    want = np.asarray(jax_scan(jnp.asarray(q), jnp.asarray(g),
                               jnp.asarray(pen), tile_rows=256,
                               interpret=True))
    got = S.int8_scan_scores(torch.from_numpy(q), torch.from_numpy(g),
                             torch.from_numpy(pen)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_dim_beyond_exact_range_raises():
    q = torch.zeros(1, 1041, dtype=torch.int8)
    with pytest.raises(ValueError, match="exact"):
        S.int8_scan_scores(q, torch.zeros(4, 1041, dtype=torch.int8),
                           torch.zeros(4))


def test_quantize_rounds_half_to_even_like_jax():
    x = np.array([[0.5 / 127, 1.5 / 127, 2.5 / 127, -0.5 / 127, -2.5 / 127,
                   1.0, -1.0, 0.3]], np.float32)
    want = np.asarray(jsearch.quantize_rows_int8(jnp.asarray(x)))
    got = tsearch.quantize_rows_int8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _search_inputs(seed, n=2048, d=64, q=6):
    rng = np.random.default_rng(seed)
    g = _unit_rows(rng, n, d)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    mask = rng.random(n) < 0.8
    g_i8 = np.array(jsearch.quantize_rows_int8(jnp.asarray(g)))
    return queries, g, g_i8, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_scan_topk_matches_jax_int8_cosine_topk(seed):
    """Scores to 1e-6 (the same f32 rescore, summed in another order) and
    the same id sets."""
    queries, g, g_i8, mask = _search_inputs(seed)
    k = 10
    js, ji = jsearch.int8_cosine_topk(
        jnp.asarray(queries), jnp.asarray(g_i8), jnp.asarray(g),
        jnp.asarray(mask), k=k, rescore=256)
    ts, ti = tsearch.int8_scan_topk(
        torch.from_numpy(queries), torch.from_numpy(g_i8), torch.from_numpy(g),
        torch.from_numpy(mask), k=k, rescore=256)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    for a, b in zip(ti.numpy(), np.asarray(ji)):
        assert set(a) == set(b)
    assert mask[ti.numpy()].all()


def test_int8_cosine_topk_twins_agree():
    queries, g, g_i8, mask = _search_inputs(3)
    args = [torch.from_numpy(a) for a in (queries, g_i8, g, mask)]
    s1, i1 = tsearch.int8_cosine_topk(*args, k=5, rescore=64)
    s2, i2 = tsearch.int8_scan_topk(*args, k=5, rescore=64)
    torch.testing.assert_close(s1, s2, atol=0, rtol=0)
    assert [set(r) for r in i1.tolist()] == [set(r) for r in i2.tolist()]
    js, ji = jsearch.int8_cosine_topk(
        jnp.asarray(queries), jnp.asarray(g_i8), jnp.asarray(g),
        jnp.asarray(mask), k=5, rescore=64)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("exact", [True, False])
def test_masked_cosine_topk_matches_jax(exact):
    """f32 tier to 1e-6; bf16 tier (bf16 operands, f32 scores) to 1e-6 as
    well, since both sides form exact bf16 products in f32."""
    queries, g, _, mask = _search_inputs(4, n=1000)
    js, ji = jsearch.masked_cosine_topk(
        jnp.asarray(queries), jnp.asarray(g), jnp.asarray(mask), k=7,
        exact=exact, gallery_normalized=True)
    ts, ti = tsearch.masked_cosine_topk(
        torch.from_numpy(queries), torch.from_numpy(g), torch.from_numpy(mask),
        k=7, exact=exact, gallery_normalized=True)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    for a, b in zip(ti.numpy(), np.asarray(ji)):
        assert set(a) == set(b)


def test_cpu_tensor_takes_plain_version_without_launch():
    before = S.KERNEL.launches
    S.int8_scan_scores(torch.zeros(1, 16, dtype=torch.int8),
                       torch.zeros(3, 16, dtype=torch.int8), torch.zeros(3))
    assert S.KERNEL.launches == before

