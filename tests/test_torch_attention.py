"""Port parity: flash attention with and without SAM's rel-pos bias (kernels
B6 and B7) against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX side runs
the Pallas kernels in interpret mode, as tests/test_flash_2d_bias.py and
tests/test_pallas_attention.py do. Tolerances are theirs: 3e-5 with the
bias, 2e-5 without.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.ops import attention as JA
from retrieval_based_object_detection_tpu_torch.ops import attention as A


def _inputs(seed, B, H, gh, gw, D):
    rng = np.random.default_rng(seed)
    T = gh * gw
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    bh = rng.normal(size=(B, H, T, gh)).astype(np.float32)
    bw = rng.normal(size=(B, H, T, gw)).astype(np.float32)
    return q, k, v, bh, bw


def _oracle(q, k, v, bh, bw, gh, gw):
    """The einsum oracle of tests/test_flash_2d_bias.py in float64."""
    B, H, T, D = q.shape
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) * D ** -0.5
    s = (s.reshape(B, H, T, gh, gw) + bh[..., :, None] + bw[..., None, :]
         ).reshape(B, H, T, T)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,H,gh,gw,D,block_q,block_k", [
    (1, 2, 8, 8, 32, 16, 16),
    (1, 1, 8, 4, 16, 8, 8),  # 2 grid rows per K tile on the JAX side
])
def test_2d_bias_plain_matches_pallas_interpret(B, H, gh, gw, D, block_q,
                                                block_k):
    q, k, v, bh, bw = _inputs(gh * gw + D, B, H, gh, gw, D)
    want = np.asarray(JA.flash_attention_2d_bias(
        q, k, v, bh, bw, grid_h=gh, grid_w=gw, block_q=block_q,
        block_k=block_k, interpret=True))
    got = A.flash_attention_2d_bias(*_t(q, k, v, bh, bw), gh, gw).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)


@pytest.mark.parametrize("gh,gw,D", [(7, 9, 16), (14, 14, 64), (3, 11, 40)])
def test_2d_bias_plain_at_ragged_grids_matches_oracle(gh, gw, D):
    """Grids whose T is no multiple of any tile (the TPU kernel asserts
    on them; the port takes any T)."""
    q, k, v, bh, bw = _inputs(gh + gw, 2, 2, gh, gw, D)
    got = A.flash_attention_2d_bias(*_t(q, k, v, bh, bw), gh, gw).numpy()
    np.testing.assert_allclose(got, _oracle(q, k, v, bh, bw, gh, gw),
                               atol=3e-5)


@pytest.mark.parametrize("B,H,T,D,block", [(2, 2, 512, 64, 128),
                                           (1, 1, 128, 32, 128)])
def test_flash_plain_matches_pallas_interpret(B, H, T, D, block):
    rng = np.random.default_rng(T + D)
    q, k, v = (rng.normal(size=(B, H, T, D)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(JA.flash_attention(q, k, v, block_q=block,
                                         block_k=block, interpret=True))
    got = A.flash_attention(*_t(q, k, v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_flash_plain_extreme_logits_stay_finite():
    """Large-magnitude logits (tests/test_pallas_attention.py)."""
    rng = np.random.default_rng(4)
    q, k = (30.0 * rng.normal(size=(1, 1, 256, 16)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(1, 1, 256, 16)).astype(np.float32)
    got = A.flash_attention(*_t(q, k, v)).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(JA.flash_attention(q, k, v, block_q=128, block_k=128,
                                         interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_reference_attention_matches_jax(bf16):
    """f32 to 2e-5; bf16 end to end, where p and the output round to bf16
    on both sides, to one bf16 ulp (2^-7 relative)."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(2, 2, 50, 32)).astype(np.float32)
               for _ in range(3))
    if bf16:
        q, k, v = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    want = np.asarray(JA.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)) for a in (q, k, v))
    if bf16:
        tq, tk, tv = (t.bfloat16() for t in (tq, tk, tv))
    got = A.reference_attention(tq, tk, tv).float().numpy()
    tol = dict(atol=2 ** -7, rtol=2 ** -7) if bf16 else dict(atol=2e-5)
    np.testing.assert_allclose(got, want, **tol)


def test_cpu_tensors_take_the_plain_versions_without_launch():
    q, k, v, bh, bw = _t(*_inputs(0, 1, 1, 2, 3, 8))
    before = A.KERNEL.launches
    A.flash_attention(q, k, v)
    A.flash_attention_2d_bias(q, k, v, bh, bw, 2, 3)
    assert A.KERNEL.launches == before


def test_2d_bias_rejects_a_grid_that_is_not_t():
    q, k, v, bh, bw = _t(*_inputs(0, 1, 1, 2, 3, 8))
    with pytest.raises(ValueError, match="grid_h"):
        A.flash_attention_2d_bias(q, k, v, bh, bw, 2, 2)
    with pytest.raises(ValueError, match="bias tables"):
        A.flash_attention_2d_bias(q, k, v, bw, bh, 2, 3)
