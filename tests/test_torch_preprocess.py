"""Port parity: the CLIP device preprocess (``preprocess_batch``).

JAX resizes with ``jax.image.resize(method="bicubic", antialias=True)``;
the port writes the same separable Keys-cubic weight matrices out by hand
(``ops.image.resize_bicubic``). The same numpy-seeded uint8 batches go
through both, f32, held to 1e-5 (normalised units).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.models.clip import preprocess as jpre
from retrieval_based_object_detection_tpu_torch.models.clip import (
    preprocess as tpre,
)
from retrieval_based_object_detection_tpu_torch.ops import image as timage

ATOL = 1e-5


@pytest.mark.parametrize("shape,size", [
    ((2, 100, 150, 3), 64),    # landscape, upsampled
    ((2, 300, 240, 3), 224),   # portrait, downsampled (antialias)
    ((1, 224, 224, 3), 224),   # identity size: no resize at all
    ((2, 57, 500, 3), 64),     # one side up, the other down
    ((1, 480, 640, 3), 224),   # a camera frame
    ((3, 225, 224, 3), 224),   # one axis off by one
])
def test_preprocess_batch_matches_jax(shape, size):
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                   dtype=np.uint8)
    want = np.asarray(jpre.preprocess_batch(jnp.asarray(x), size=size))
    got = tpre.preprocess_batch(torch.from_numpy(x), size=size)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_float_input_matches_jax():
    x = np.random.default_rng(1).uniform(0, 255, (2, 90, 120, 3)).astype(
        np.float32)
    want = np.asarray(jpre.preprocess_batch(jnp.asarray(x), size=48))
    got = tpre.preprocess_batch(torch.from_numpy(x), size=48).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(57, 64), (500, 561), (640, 298)])
def test_resize_bicubic_matches_jax_image_resize(n_in, n_out):
    """One axis at a time, against jax.image.resize under jit (XLA fuses
    each sample position into one rounding, which the port reproduces)."""
    x = np.random.default_rng(n_in).random((1, n_in, 5, 2)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda a: jax.image.resize(
        a, (1, n_out, 5, 2), "bicubic", antialias=True))(jnp.asarray(x)))
    got = timage.resize_bicubic(torch.from_numpy(x), n_out, 5).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
