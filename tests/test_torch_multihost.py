"""Port parity: the multi-host helpers and the device mesh.

``host_shard_range`` and ``merge_host_topk`` are host numpy copied from the
JAX package: equal outputs on seeded inputs. ``initialize`` keeps the JAX
rules (a no-op without arguments or when a process group exists) and
bootstraps a world of one on gloo. The mesh keeps JAX's shape and error
rules and admits a repeated device. Oracle: tests/test_parallel.py,
tests/test_multihost_dcn.py.
"""

import socket

import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.parallel import multihost as jmh
from retrieval_based_object_detection_tpu_torch.parallel import mesh as tmesh
from retrieval_based_object_detection_tpu_torch.parallel import (
    multihost as tmh,
)


@pytest.mark.parametrize("n_rows", [0, 1, 7, 1000, 1_048_577])
def test_host_shard_range_matches_jax(n_rows):
    for count in (1, 2, 3, 8):
        ranges = [tmh.host_shard_range(n_rows, p, count) for p in range(count)]
        assert ranges == [jmh.host_shard_range(n_rows, p, count)
                          for p in range(count)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n_rows
    # Without a process group this process is host 0 of 1.
    assert tmh.host_shard_range(n_rows) == (0, n_rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_host_topk_matches_jax(seed):
    rng = np.random.default_rng(seed)
    hosts, q, k = 3, 5, 4
    scores = [np.sort(rng.normal(size=(q, k)).astype(np.float32), 1)[:, ::-1]
              for _ in range(hosts)]
    if seed == 2:  # ties across hosts and -inf padding
        scores[1][:, 0] = scores[0][:, 0]
        scores[2][:, 2:] = -np.inf
    idx = [rng.integers(0, 10_000, (q, k)) for _ in range(hosts)]
    got = tmh.merge_host_topk(scores, idx, k)
    want = jmh.merge_host_topk(scores, idx, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_initialize_rules_and_a_world_of_one():
    import torch.distributed as dist

    tmh.initialize()  # no arguments: a no-op
    assert not dist.is_initialized() and tmh.process_info() == (0, 1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmh.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        assert tmh.process_info() == (0, 1)
        t = torch.ones(3)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
        # A second bootstrap while the group exists: a no-op.
        tmh.initialize("127.0.0.1:1", 4, 3, device="cpu")
        assert tmh.process_info() == (0, 1)
    finally:
        dist.destroy_process_group()


def test_initialize_raises_on_a_bad_bootstrap():
    """A bootstrap failure other than "already initialised" raises: it is
    never swallowed into a world of one."""
    with pytest.raises(ValueError, match="Port"):
        tmh.initialize("127.0.0.1:notaport", 2, 0, device="cpu")
    assert tmh.process_info() == (0, 1)


def test_mesh_shapes_and_errors():
    m = tmesh.make_mesh({"dp": 2, "tp": 4}, ["cpu"] * 8)
    assert m.shape == {"dp": 2, "tp": 4} and m.devices.size == 8
    assert "gallery" not in m.shape
    with pytest.raises(ValueError, match="multiply"):
        tmesh.make_mesh({"gallery": 3}, ["cpu"] * 4)
    g = tmesh.gallery_mesh(8, device="cpu")
    assert g.shape == {"gallery": 8}
    assert g.axis_devices("gallery") == [torch.device("cpu")] * 8
    sub = tmesh.make_mesh({"dp": 2, "gallery": 2}, ["cpu"] * 4)
    assert len(sub.axis_devices("gallery")) == 2
    assert tmesh.device_count("cpu") == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.gallery_mesh(1)
