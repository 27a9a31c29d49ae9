"""Port parity: the int4 gallery scan (kernel B3), its packing and search
tiers, and the store's int4 method, against the JAX package.

The JAX scan runs in Pallas interpret mode, as tests/test_int4_search.py
runs it. Packed bytes, scales and scan scores are exact integer math scaled
by the same f32 factors, so they are compared bit for bit; top-k results by
id sets and scores (rtol 1e-6: the same f32 rescore summed in another
order), since neither top-k promises an order among ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery import search as jsearch
from retrieval_based_object_detection_tpu.gallery.store import Gallery as JGallery
from retrieval_based_object_detection_tpu.ops.int4_scan import (
    int4_scan_scores as jax_scan,
)
from retrieval_based_object_detection_tpu_torch.gallery import schema as tschema
from retrieval_based_object_detection_tpu_torch.gallery import search as tsearch
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
)
from retrieval_based_object_detection_tpu_torch.ops import int4_scan as S

DIM = 64


def _unit_rows(rng, n, d=DIM):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("scale", [1.0, 1e-8, 1e8])
def test_pack_rows_int4_bit_exact_vs_jax(scale):
    """Bytes and scales equal bit for bit, zero rows and single-dominant
    rows included, at any dynamic range."""
    rng = np.random.default_rng(int(np.log10(scale)) + 20)
    rows = (rng.normal(size=(64, DIM)) * scale).astype(np.float32)
    rows[0] = 0.0
    rows[1] = 0.0
    rows[1, 3] = scale
    rows[2, :] = 0.5 * scale  # exact half steps: round half to even
    jp, js = jsearch.pack_rows_int4(jnp.asarray(rows))
    tp, ts = tsearch.pack_rows_int4(torch.from_numpy(rows))
    assert tp.dtype == torch.int8 and tp.shape == (64, DIM // 2)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_unpack_matches_the_shift_oracle_for_every_byte():
    b = torch.arange(-128, 128, dtype=torch.int8).reshape(1, 256)
    got = S.unpack_int4(b).numpy().astype(np.int32)
    p = b.numpy().astype(np.int32)
    np.testing.assert_array_equal(got[:, :256], (p & 15) - 8)
    np.testing.assert_array_equal(got[:, 256:], p >> 4)


@pytest.mark.parametrize("Q,N,D", [(4, 512, 64), (16, 1024, 512),
                                   (3, 256, 32)])
def test_plain_scores_bit_exact_vs_pallas_interpret(Q, N, D):
    """Random packed bytes (every nibble value), positive scales, 10% of
    rows masked; the query halves differ, so a lo/hi swap would show."""
    rng = np.random.default_rng(Q * N + D)
    q = rng.integers(-127, 128, (Q, D), dtype=np.int8)
    q[:, D // 2:] = rng.integers(-127, 128, (Q, D // 2), dtype=np.int8) // 3
    packed = rng.integers(-128, 128, (N, D // 2), dtype=np.int8)
    scales = (rng.random(N) * 0.2 + 1e-3).astype(np.float32)
    pen = np.where(rng.random(N) < 0.1, jsearch.NEG_INF, 0.0).astype(np.float32)
    want = np.asarray(jax_scan(jnp.asarray(q), jnp.asarray(packed),
                               jnp.asarray(scales), jnp.asarray(pen),
                               interpret=True))
    got = S.int4_scan_scores(*(torch.from_numpy(a)
                               for a in (q, packed, scales, pen))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_dim_beyond_exact_range_raises():
    with pytest.raises(ValueError, match="exact"):
        S.int4_scan_scores(torch.zeros(1, 16514, dtype=torch.int8),
                           torch.zeros(2, 8257, dtype=torch.int8),
                           torch.ones(2), torch.zeros(2))


def _search_inputs(seed, n=1024, q=8):
    rng = np.random.default_rng(seed)
    g = _unit_rows(rng, n)
    queries = rng.normal(size=(q, DIM)).astype(np.float32)
    mask = rng.random(n) < 0.85
    packed, scales = (np.array(a) for a in
                      jsearch.pack_rows_int4(jnp.asarray(g)))
    return queries, g, packed, scales, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_int4_cosine_topk_matches_jax(seed):
    queries, g, packed, scales, mask = _search_inputs(seed)
    js, ji = jsearch.int4_cosine_topk(
        jnp.asarray(queries), jnp.asarray(packed), jnp.asarray(scales),
        jnp.asarray(g), jnp.asarray(mask), k=10, rescore=64)
    args = [torch.from_numpy(a) for a in (queries, packed, scales, g, mask)]
    ts, ti = tsearch.int4_cosine_topk(*args, k=10, rescore=64)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    for a, b in zip(ti.numpy(), np.asarray(ji)):
        assert set(a) == set(b)
    assert mask[ti.numpy()].all()
    # The scan path (plain scores on CPU tensors, penalty in the scores)
    # is the same tier.
    ss, si = tsearch.int4_scan_topk(*args, k=10, rescore=64)
    torch.testing.assert_close(ss, ts, atol=0, rtol=0)
    assert [set(r) for r in si.tolist()] == [set(r) for r in ti.tolist()]


def _fill(mod, g, n, rng, cls="c"):
    vecs = rng.normal(size=(n, DIM)).astype(np.float32)
    g.upsert([f"{cls}{i}" for i in range(n)], vecs,
             [mod.Payload(data_type="original_images", class_name=cls,
                          img_path=f"/{cls}/{i}.png") for i in range(n)])
    return vecs


def _same_hits(tres, jres):
    for th, jh in zip(tres, jres):
        assert {h.id for h in th} == {h.id for h in jh}
        np.testing.assert_allclose(sorted(h.score for h in th),
                                   sorted(h.score for h in jh), rtol=1e-6)


def test_store_int4_search_matches_jax_and_respects_filter():
    rng = np.random.default_rng(7)
    jg, tg = JGallery("t", dim=DIM), TGallery("t", dim=DIM, device="cpu")
    for cls in ("a", "b"):
        state = rng.bit_generator.state
        vb = _fill(jschema, jg, 300, rng, cls)
        rng.bit_generator.state = state
        _fill(tschema, tg, 300, rng, cls)
    queries = rng.normal(size=(6, DIM)).astype(np.float32)
    _same_hits(tg.search(queries, k=10, method="int4"),
               jg.search(queries, k=10, method="int4"))
    jf = jschema.Filter(must={"class_name": "a"})
    tf = tschema.Filter(must={"class_name": "a"})
    thits = tg.search(vb[:3], k=5, method="int4", flt=tf)
    _same_hits(thits, jg.search(vb[:3], k=5, method="int4", flt=jf))
    assert all(h.payload.class_name == "a" for hits in thits for h in hits)
    assert tg._dev_int4 is not None and tg._dev_int8 is None


def test_store_int4_mirror_patches_after_write():
    """A write after the int4 mirror exists is visible to the next int4
    search in both packages (a patch, not a stale mirror), and the patched
    mirror equals a fresh pack of the f32 mirror."""
    rng = np.random.default_rng(3)
    jg, tg = JGallery("t", dim=DIM), TGallery("t", dim=DIM, device="cpu")
    state = rng.bit_generator.state
    _fill(jschema, jg, 500, rng)
    rng.bit_generator.state = state
    _fill(tschema, tg, 500, rng)
    probe = rng.normal(size=(DIM,)).astype(np.float32)
    _same_hits(tg.search(probe, k=3, method="int4"),
               jg.search(probe, k=3, method="int4"))
    mirror = tg._dev_int4
    target = rng.normal(size=(DIM,)).astype(np.float32)
    for mod, g in ((jschema, jg), (tschema, tg)):
        g.upsert(["hit"], target[None, :],
                 [mod.Payload(data_type="original_images", class_name="new",
                              img_path="/new/0.png")])
        g.upsert(["c7"], -target[None, :],  # an overwrite, too
                 [mod.Payload(data_type="original_images", class_name="c",
                              img_path="/c/7.png")])
    for g in (jg, tg):
        hits = g.search(target, k=1, method="int4")[0]
        assert hits[0].id == "hit" and hits[0].score > 0.999
    assert tg._dev_int4 is mirror  # patched in place, not rebuilt
    packed, scales = tsearch.pack_rows_int4(tg._dev_f32)
    assert torch.equal(tg._dev_int4[0], packed)
    assert torch.equal(tg._dev_int4[1], scales)


def test_store_int4_rejects_odd_dim():
    g = TGallery("odd", dim=33, device="cpu")
    g.upsert(["o"], np.ones((1, 33), np.float32),
             [tschema.Payload(data_type="original_images", class_name="o")])
    with pytest.raises(ValueError, match="even dim"):
        g.search(np.ones(33, np.float32), method="int4")


def test_cpu_tensor_takes_plain_version_without_launch():
    before = S.KERNEL.launches
    S.int4_scan_scores(torch.zeros(1, 32, dtype=torch.int8),
                       torch.zeros(3, 16, dtype=torch.int8), torch.ones(3),
                       torch.zeros(3))
    assert S.KERNEL.launches == before
