"""Port parity: the blocked medoid (kernel B4) against the JAX package.

The JAX kernel runs in Pallas interpret mode, as tests/test_pallas_medoid.py
runs it, on rows padded to its block with a column mask; the port's plain
version takes the rows as they are. Sums are held to the JAX package's own
tolerance (rtol 1e-4, atol 5e-2: the Gram trick's cancellation noise on
near-zero distances, summed over the row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.ops import delegates as jd
from retrieval_based_object_detection_tpu.ops import medoid as jm
from retrieval_based_object_detection_tpu_torch.ops import delegates as td
from retrieval_based_object_detection_tpu_torch.ops import medoid as tm

RTOL, ATOL = 1e-4, 5e-2


def _jax_sums(v, block):
    n = v.shape[0]
    padded = max(block, -(-n // block) * block)
    buf = np.zeros((padded, v.shape[1]), np.float32)
    buf[:n] = v
    mask = np.zeros(padded, bool)
    mask[:n] = True
    return np.asarray(jm.pairwise_distance_sums(
        jnp.asarray(buf), jnp.asarray(mask), block=block,
        interpret=True))[:n]


@pytest.mark.parametrize("n,d", [(700, 32), (257, 512), (1, 8)])
def test_plain_sums_match_pallas_interpret(n, d):
    """N not a multiple of the JAX block: the padded rows must add
    nothing to the sums."""
    rng = np.random.default_rng(n + d)
    v = rng.normal(size=(n, d)).astype(np.float32)
    want = _jax_sums(v, block=256)
    got = tm.pairwise_distance_sums(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ref = np.linalg.norm(v[:, None] - v, axis=2).sum(axis=1)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_plain_sums_across_row_blocks():
    """Past one row block of the plain version (1024 rows), every block
    puts its zero diagonal at the right global column."""
    rng = np.random.default_rng(11)
    v = rng.normal(size=(2100, 8)).astype(np.float32)
    got = tm.pairwise_distance_sums_plain(torch.from_numpy(v)).numpy()
    ref = np.linalg.norm(v[:, None] - v, axis=2).sum(axis=1)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_self_distance_is_exactly_zero():
    """A lone row sums to exactly 0 in both packages: the diagonal is
    forced to 0 by index, not left to the Gram trick's residual (which
    sqrt would blow up to ~1e-3 at this norm)."""
    v = np.float32([[12.25, -31.5, 3.0, 0.5]])
    assert tm.pairwise_distance_sums(torch.from_numpy(v)).item() == 0.0
    assert _jax_sums(v, block=8)[0] == 0.0


@pytest.mark.parametrize("n,d", [(700, 24), (100, 16), (300, 512)])
def test_medoid_large_matches_jax(n, d):
    """The chosen member equals the JAX package's medoid_large (interpret
    mode) and its dense medoid."""
    rng = np.random.default_rng(n * d)
    v = rng.normal(size=(n, d)).astype(np.float32)
    got = tm.medoid_large(v, device="cpu")
    np.testing.assert_array_equal(got, jm.medoid_large(v, block=256))
    np.testing.assert_array_equal(got, np.asarray(jd.compute_medoid(v)))
    dense = td.compute_all_delegates(torch.from_numpy(v))["medoid"].numpy()
    np.testing.assert_array_equal(got, dense)


def test_medoid_index_takes_the_first_minimum():
    assert tm.medoid_index(torch.tensor([3.0, 1.0, 1.0, 2.0])) == 1


def test_cpu_tensor_takes_plain_version_without_launch():
    before = tm.KERNEL.launches
    tm.pairwise_distance_sums(torch.ones(5, 4))
    assert tm.KERNEL.launches == before


def test_medoid_large_default_device_is_cuda():
    """No silent CPU fallback: the default device is CUDA, which raises
    where there is no GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.medoid_large(np.ones((3, 4), np.float32))
