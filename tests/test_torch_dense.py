"""Port parity: the f32-output dense layer (``ops.dense.dense_f32``) that
keeps a bf16 product's sum in f32 before an activation, against the JAX
package's ``jnp.dot(..., preferred_element_type=jnp.float32) + b``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu_torch.ops.dense import dense_f32


def _operands(seed, n=37, k=64, m=48):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, n, k)).astype(np.float32),
            rng.normal(0, k ** -0.5, (k, m)).astype(np.float32),
            rng.normal(size=m).astype(np.float32))


def test_f32_path_is_the_plain_addmm():
    x, w, b = (torch.from_numpy(a) for a in _operands(0))
    got = dense_f32(x, w, b)
    want = torch.addmm(b, x.reshape(-1, 64), w).reshape(2, 37, 48)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("seed", [1, 2])
def test_bf16_sum_stays_f32_as_jax(seed):
    """bf16 operands: the f32 sum of exact products, as JAX's
    f32-preferred dot (1e-6: f32 sums in another order), never rounded to
    bf16 (which would be off by up to 2^-9 relative)."""
    x, w, b = _operands(seed)
    bf = jnp.bfloat16
    want = np.asarray(jnp.dot(jnp.asarray(x).astype(bf),
                              jnp.asarray(w).astype(bf),
                              preferred_element_type=jnp.float32)
                      + jnp.asarray(b).astype(bf))
    got = dense_f32(*(torch.from_numpy(a).bfloat16() for a in (x, w, b)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    rounded = got.bfloat16().float().numpy()
    assert np.abs(rounded - want).max() > 1e-4


def test_bf16_gradients_reach_the_bf16_operands():
    x, w, b = (torch.from_numpy(a).bfloat16().requires_grad_(True)
               for a in _operands(3))
    dense_f32(x, w, b).square().sum().backward()
    xr, wr, br = (t.detach().float().requires_grad_(True) for t in (x, w, b))
    (xr @ wr + br).square().sum().backward()
    for got, want in ((x, xr), (w, wr), (b, br)):
        assert got.grad.dtype == torch.bfloat16
        torch.testing.assert_close(got.grad.float(), want.grad,
                                   rtol=2 ** -7, atol=0)
