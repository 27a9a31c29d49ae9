"""Port parity: the augment ops of ``ops/image.py``.

Brightness and rotation equal the JAX package's output bit for bit at
every rate and angle of the reference grid; the blur equals it after its
rounding but for a few pixels one grey level off (XLA's convolution sums
its taps in another order). The noise ops cannot share JAX's threefry
bits: they are held by their statistics and determinism, and their
arithmetic bit for bit when both sides are fed the same draws.
"""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from retrieval_based_object_detection_tpu.ops import image as J
from retrieval_based_object_detection_tpu_torch.ops import image as T

SHAPES = [(37, 53, 4), (64, 48, 3), (101, 77, 4)]


def _img(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.float32)


def test_grid_constants_are_the_references():
    assert T.BRIGHTNESS_RATES == J.BRIGHTNESS_RATES
    assert T.ROTATION_ANGLES == J.ROTATION_ANGLES
    assert T.NOISE_TYPES == J.NOISE_TYPES
    assert T.NOISE_LEVELS == J.NOISE_LEVELS


@pytest.mark.parametrize("shape", SHAPES)
def test_brightness_bit_for_bit(shape):
    x = _img(shape)
    for rate in J.BRIGHTNESS_RATES:
        np.testing.assert_array_equal(
            T.brightness(torch.from_numpy(x), rate).numpy(),
            np.asarray(J.brightness(x, rate)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("angle", J.ROTATION_ANGLES)
def test_rotate_expand_bit_for_bit(shape, angle):
    x = _img(shape, seed=angle)
    got = T.rotate_expand(torch.from_numpy(x), float(angle)).numpy()
    want = np.asarray(J.rotate_expand(x, float(angle)))
    assert got.shape == want.shape
    assert T.rotate_expand_size(shape[1], shape[0], angle) == \
        J.rotate_expand_size(shape[1], shape[0], angle)
    np.testing.assert_array_equal(got, want)


def test_rotate_expand_size_matches_pil():
    arr = np.zeros((37, 53, 4), np.uint8)
    for angle in J.ROTATION_ANGLES:
        ref = Image.fromarray(arr, "RGBA").rotate(angle, expand=True)
        assert T.rotate_expand_size(53, 37, angle) == ref.size


def test_gaussian_kernel_matches():
    for radius in (2, 4, 6):
        np.testing.assert_allclose(T._gaussian_kernel(radius).numpy(),
                                   np.asarray(J._gaussian_kernel(radius)),
                                   atol=1e-7, rtol=0)


@pytest.mark.parametrize("radius", [2, 4, 6])
def test_gaussian_blur_matches_to_one_grey_level(radius):
    """Tolerance: 1 grey level on at most 0.1% of pixels; the sums before
    the round-half-even differ in the last bits (tap order)."""
    for shape in SHAPES:
        x = _img(shape, seed=radius)
        got = T.gaussian_blur(torch.from_numpy(x), radius).numpy()
        want = np.asarray(J.gaussian_blur(x, radius))
        d = np.abs(got - want)
        assert d.max() <= 1.0
        assert (d > 0).mean() <= 1e-3
        # Batched input gives the same as one image at a time.
        both = T.gaussian_blur(torch.from_numpy(np.stack([x, x])), radius)
        np.testing.assert_array_equal(both[1].numpy(), got)
    const = np.full((16, 16, 3), 77.0, np.float32)
    np.testing.assert_array_equal(
        T.gaussian_blur(torch.from_numpy(const), radius).numpy(), const)


def test_gaussian_noise_arithmetic_on_the_same_draws():
    """Tolerance: one f32 step at 255 (1.5e-5). JAX draws the normals
    inside the jitted op, where XLA fuses them into the sum and rounds
    some of them one step from the standalone draw fed to the port."""
    x = _img((40, 30, 4))
    key = jax.random.key(3)
    normal = np.array(jax.random.normal(key, x.shape, jax.numpy.float32))
    for amount in J.NOISE_LEVELS:
        want = np.asarray(J.gaussian_noise(x, amount, key))
        got = T._add_gaussian(torch.from_numpy(x), amount,
                              torch.from_numpy(normal)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=float(np.spacing(np.float32(255))))


def test_salt_pepper_arithmetic_on_the_same_draws():
    x = _img((40, 30, 4))
    key = jax.random.key(4)
    k1, k2 = jax.random.split(key)
    u_hit = np.array(jax.random.uniform(k1, x.shape[:-1]))
    u_salt = np.array(jax.random.uniform(k2, x.shape[:-1]))
    for amount in J.NOISE_LEVELS:
        want = np.asarray(J.salt_pepper(x, amount, key))
        got = T._apply_salt_pepper(torch.from_numpy(x), amount,
                                   torch.from_numpy(u_hit),
                                   torch.from_numpy(u_salt)).numpy()
        np.testing.assert_array_equal(got, want)


def test_noise_statistics_and_determinism():
    x = np.full((64, 64, 3), 128.0, np.float32)
    g = torch.Generator().manual_seed(0)
    out = T.gaussian_noise(torch.from_numpy(x), 0.02, g).numpy()
    d = out - x
    assert abs(d.mean()) < 0.1
    assert abs(d.std() - 25 * 0.02) < 0.05
    out2 = T.gaussian_noise(torch.from_numpy(x), 0.02,
                            torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(out, out2)

    y = np.full((100, 100, 4), 128.0, np.float32)
    snp = T.salt_pepper(torch.from_numpy(y), 0.03,
                        torch.Generator().manual_seed(1)).numpy()
    changed = (snp != y).any(axis=-1)
    assert 0.02 < changed.mean() < 0.04
    assert set(np.unique(snp[changed])) <= {0.0, 255.0}
    # All channels of a hit pixel take one value.
    assert (snp[changed] == snp[changed][:, :1]).all()
    np.testing.assert_array_equal(
        snp, T.salt_pepper(torch.from_numpy(y), 0.03,
                           torch.Generator().manual_seed(1)).numpy())


def test_expand_box_with_margin_matches():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 300, (50, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(1, 200, (50, 2))
    np.testing.assert_array_equal(
        T.expand_box_with_margin(boxes, 320, 240, 0.2),
        J.expand_box_with_margin(boxes, 320, 240, 0.2))
