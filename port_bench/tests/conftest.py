"""Shared set-up of the benchmark's tests: the harness's folder and the
checkout on ``sys.path``, ``run.py`` and ``control.py`` loaded by path, a
tiny CLIP configuration and tiny traffic for running cells on the CPU,
and the ``cuda`` fixture for tests that need the card."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CLIP = {"width": 64, "layers": 2, "heads": 2, "embed_dim": 32,
             "image_size": 64, "patch_size": 32}
TINY_TRAFFIC = {
    "detect_http": {"rate_per_s": 12.0, "serving_size": 128,
                    "photo_sizes": [[96, 128], [128, 96]],
                    "photos_per_size": 2, "gallery_classes": 4,
                    "crops_per_class": 2, "check_requests": 6,
                    "trace_seconds": 0.5, "sender_threads": 8,
                    "warm_seconds": 0.5},
    "search_inproc": {"rows": 20000, "dim": 64, "calls_per_caller": 8,
                      "check_calls": 6, "trace_seconds": 0.5},
    "embed_tree": {"crops": 48, "classes": 4, "min_side": 48,
                   "max_side": 96, "check_crops": 12},
}


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        "pb_test_" + name.replace("/", "_").replace(".", "_"), BENCH / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="session")
def bench_run():
    return load("run.py")


@pytest.fixture(scope="session")
def bench_control():
    return load("control.py")


@pytest.fixture
def cuda():
    """Skip unless a card is present; decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def tiny_cell(bench_run):
    """``tiny_cell(cell, seed)`` → the result line of a CPU run of
    ``cell`` at a tiny size, one second long."""
    import time

    from benchcore import spec

    def go(cell: str, seed: int = 2 ** 31 + 77, trace: bool = False):
        kind = spec.workload(cell)["traffic"]
        return bench_run.run_cell(cell, seed, 1.0, trace, device="cpu",
                                  cfg_override=TINY_CLIP,
                                  params_override=TINY_TRAFFIC[kind],
                                  t_process=time.perf_counter())

    return go


@pytest.fixture
def int8_on_cpu(monkeypatch):
    """Route inexact searches to the int8 tier on the CPU too (its plain
    scan), as they route on the card at a million rows."""
    from retrieval_based_object_detection_tpu_torch.gallery.store import (
        Gallery,
    )

    search = Gallery.search

    def routed(self, queries, k=10, flt=None, exact=True, **kw):
        if not exact and kw.get("method") is None:
            kw["method"] = "int8"
        return search(self, queries, k=k, flt=flt, exact=exact, **kw)

    monkeypatch.setattr(Gallery, "search", routed)
    return routed
