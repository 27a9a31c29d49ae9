"""Port parity: the attention core (kernel B1) against the JAX Pallas kernel.

On the CPU the port runs its plain version; the JAX side runs the Pallas
kernel in interpret mode, as tests/test_clip_fused_attention.py does.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

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

