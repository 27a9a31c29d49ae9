"""Port parity: the attention core (kernels B1 and B5) against the JAX
Pallas kernels.

On the CPU the port runs its plain versions; the JAX side runs the Pallas
kernels in interpret mode, as tests/test_clip_fused_attention.py does.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.ops.clip_attention import (
    _pallas_attn_bwd,
)
from retrieval_based_object_detection_tpu.ops.clip_attention import (
    clip_attention_core as jax_core,
)
from retrieval_based_object_detection_tpu_torch.ops import clip_attention as CA


def _qkv(rng, B, T, W):
    return rng.normal(0.0, 1.0, (B, T, 3 * W)).astype(np.float32)


@pytest.mark.parametrize("B,T,heads,D", [(2, 50, 2, 64), (3, 17, 4, 8),
                                         (1, 5, 1, 16)])
def test_plain_matches_pallas_interpret_f32(B, T, heads, D):
    """f32 to 1e-5 — the tolerance the JAX package holds its own kernel
    to against its einsum path."""
    qkv = _qkv(np.random.default_rng(B * T), B, T, heads * D)
    want = np.asarray(jax_core(jnp.asarray(qkv), heads=heads, interpret=True))
    got = CA.clip_attention_core(torch.from_numpy(qkv), heads).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plain_matches_pallas_interpret_bf16_values_in_f32():
    """bf16-representable inputs computed in f32 on both sides: the
    algorithm, free of bf16 rounding in the frameworks, to 1e-5."""
    qkv = _qkv(np.random.default_rng(5), 2, 50, 128)
    qkv = qkv.astype(ml_dtypes.bfloat16).astype(np.float32)
    want = np.asarray(jax_core(jnp.asarray(qkv), heads=2, interpret=True))
    got = CA.clip_attention_core(torch.from_numpy(qkv), 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plain_matches_pallas_interpret_bf16():
    """bf16 end to end: p and the output are rounded to bf16 on both sides
    (one bf16 ulp apart where the two f32 sums round differently)."""
    qkv = _qkv(np.random.default_rng(6), 2, 50, 128).astype(ml_dtypes.bfloat16)
    want = np.asarray(jax_core(jnp.asarray(qkv), heads=2, interpret=True)
                      ).astype(np.float32)
    got = CA.clip_attention_core(
        torch.from_numpy(qkv.astype(np.float32)).to(torch.bfloat16), 2
    ).float().numpy()
    np.testing.assert_allclose(got, want, atol=2 ** -7, rtol=2 ** -7)


def test_cpu_tensor_takes_plain_version_without_launch():
    before = CA.KERNEL.launches
    CA.clip_attention_core(torch.zeros(1, 4, 24), heads=2)
    assert CA.KERNEL.launches == before



# B5: the JAX package's custom-VJP tolerance against autodiff
# (tests/test_clip_fused_attention.py).
BWD_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("B,T,heads,D", [(2, 50, 2, 64), (3, 17, 4, 8)])
def test_plain_backward_matches_pallas_interpret(B, T, heads, D):
    rng = np.random.default_rng(B + T)
    qkv = _qkv(rng, B, T, heads * D)
    dout = rng.normal(size=(B, T, heads * D)).astype(np.float32)
    want = np.asarray(_pallas_attn_bwd(jnp.asarray(qkv), jnp.asarray(dout),
                                       heads, interpret=True))
    plain = CA.clip_attention_core_bwd_plain(
        torch.from_numpy(qkv), torch.from_numpy(dout), heads).numpy()
    np.testing.assert_allclose(plain, want, **BWD_TOL)
    # Autograd through the Function: its backward is the plain version on
    # the CPU, and it matches autodiff through the einsum path too.
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = CA.clip_attention_core(x, heads)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "AttentionCoreBackward"
    grad, = torch.autograd.grad(out, x, torch.from_numpy(dout))
    np.testing.assert_allclose(grad.numpy(), want, **BWD_TOL)
    y = torch.from_numpy(qkv).requires_grad_(True)
    ref, = torch.autograd.grad(CA.clip_attention_core_plain(y, heads), y,
                               torch.from_numpy(dout))
    np.testing.assert_allclose(grad.numpy(), ref.numpy(), **BWD_TOL)


def test_plain_backward_bf16_rounds_once():
    """bf16 qkv and dO: the backward computes in f32 and rounds once, as
    the Pallas kernel does; one bf16 ulp apart at most."""
    rng = np.random.default_rng(12)
    qkv = _qkv(rng, 2, 50, 128).astype(ml_dtypes.bfloat16)
    dout = rng.normal(size=(2, 50, 128)).astype(ml_dtypes.bfloat16)
    want = np.asarray(_pallas_attn_bwd(jnp.asarray(qkv), jnp.asarray(dout), 2,
                                       interpret=True)).astype(np.float32)
    got = CA.clip_attention_core_bwd_plain(
        torch.from_numpy(qkv.astype(np.float32)).bfloat16(),
        torch.from_numpy(dout.astype(np.float32)).bfloat16(), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-3,
                               rtol=2 ** -7)


def test_no_grad_needed_skips_the_function():
    qkv = torch.zeros(1, 4, 24)
    assert CA.clip_attention_core(qkv, heads=2).grad_fn is None
    with torch.no_grad():
        assert CA.clip_attention_core(qkv.requires_grad_(True),
                                      heads=2).grad_fn is None
