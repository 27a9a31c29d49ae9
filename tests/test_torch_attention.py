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


@pytest.mark.parametrize("D,dtype,cols,fits", [
    (64, torch.float32, 128, True),      # SAM-B global: 105,728 bytes
    (64, torch.bfloat16, 28, True),      # SAM-B windowed
    (64, torch.bfloat16, 379, True),     # the widest bf16 bias at D = 64
    (64, torch.bfloat16, 381, False),
    (128, torch.float32, 300, True),
    (64, torch.float32, 1001, False),    # a 1 × 1000 grid's bias rows
    (8, torch.bfloat16, 0, True),
])
def test_shared_memory_budget(D, dtype, cols, fits):
    """The wrapper's shared-memory count is the kernel's: two stages of
    64-key K and V rows padded to 32/64/128 head dims plus 8 elements (f32
    V rows plus 4), and for B6 two 64-entry key tables and the block's bias
    rows (64 query rows in f32, 128 in bf16) of ``(grid_h + grid_w) | 1``
    floats."""
    width = 32 if D <= 32 else 64 if D <= 64 else 128
    es, vpad, rows = (4, 4, 64) if dtype == torch.float32 else (2, 8, 128)
    want = 2 * 64 * ((width + 8) + (width + vpad)) * es
    if cols:
        want += 2 * 64 * 8 + rows * (cols | 1) * 4
    assert A._smem_bytes(D, dtype, cols) == want
    assert (want <= A.MAX_SMEM) == fits


def _grad_case(which, enabled):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1, 4, 8, generator=g) for _ in range(3))
    bh, bw = (torch.randn(1, 1, 4, 2, generator=g) for _ in range(2))
    tensors = {"q": q, "k": k, "v": v, "bias_h": bh, "bias_w": bw}
    if which:
        tensors[which].requires_grad_(True)
    return list(tensors.values()), enabled


@pytest.mark.parametrize("which", [None, "q", "k", "v", "bias_h", "bias_w"])
@pytest.mark.parametrize("enabled", [True, False])
def test_gradient_guard_predicate(which, enabled):
    """The predicate behind the CUDA branch's refusal: gradient mode on and
    any of q, k, v or the bias tables requiring a gradient. The kernels
    write through a raw pointer, so their output would carry no grad_fn."""
    tensors, enabled = _grad_case(which, enabled)
    with torch.set_grad_enabled(enabled):
        want = enabled and which is not None
        assert A.needs_grad(*tensors) is want
        if want:
            with pytest.raises(RuntimeError, match="use_flash=False"):
                A._refuse_grad("flash_attention_2d_bias", *tensors)
        else:
            A._refuse_grad("flash_attention_2d_bias", *tensors)


def test_cpu_branch_keeps_the_gradient_flowing():
    """CPU tensors take the plain versions, which autograd differentiates:
    the output has a grad_fn and every input gets a finite gradient."""
    tensors, _ = _grad_case(None, True)
    for t in tensors:
        t.requires_grad_(True)
    q, k, v, bh, bw = tensors
    out = A.flash_attention_2d_bias(q, k, v, bh, bw, 2, 2)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out.sum() + A.flash_attention(q, k, v).sum(),
                                tensors)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
