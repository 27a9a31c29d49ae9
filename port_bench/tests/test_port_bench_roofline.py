"""The roofline and operation counts against the bounds of PERF.md's
kernel table (NVIDIA H100 SXM data sheet peaks)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchcore import roofline

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_b2_bound_at_one_million_rows():
    # [16, 1,048,576, 512]: 0.1815 ms, bound by bytes.
    n_bytes, n_ops, bound = roofline.b2_call(16, 1 << 20, 512)
    assert bound * 1e3 == pytest.approx(0.1815, abs=5e-5)
    assert n_bytes / roofline.HBM_BYTES_PER_S == bound
    # A shard of the sharded tier, [16, 294,912, 512]: 0.0511 ms.
    assert roofline.b2_call(16, 294_912, 512)[2] * 1e3 == pytest.approx(
        0.0511, abs=5e-5)


@pytest.mark.parametrize("dtype, want_ms", [("bfloat16", 0.0059),
                                            ("float32", 0.0117)])
def test_b1_bound_at_a_batch_of_64(dtype, want_ms):
    # [64, 50, 2304] qkv of ViT-B/32: bound by bytes.
    n_bytes, n_ops, bound = roofline.b1_call(cfg("clip-vit-b32"), 64, dtype)
    assert bound * 1e3 == pytest.approx(want_ms, abs=5e-5)
    assert n_bytes == 64 * 50 * 4 * 768 * roofline.ITEMSIZE[dtype]


@pytest.mark.parametrize("name, gflop", [("clip-vit-b32", 8.8),
                                         ("clip-vit-l14", 162.0)])
def test_tower_forward_flops(name, gflop):
    assert roofline.clip_forward_flops(cfg(name)) / 1e9 == pytest.approx(
        gflop, rel=0.01)


def test_a_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0.0, 1.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 989e12, 989e12) == pytest.approx(1.0)
