"""The PyTorch port imports neither JAX nor the JAX package.

Each check runs in a fresh interpreter, so modules this test process has
already loaded cannot hide an import.
"""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import retrieval_based_object_detection_tpu_torch as port

REPO = Path(__file__).resolve().parents[1]


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix=port.__name__ + "."))


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) >= 30, mods
    p = "retrieval_based_object_detection_tpu_torch."
    for m in ("utils.tree", "utils.loader", "ops.medoid", "ops.int4_scan",
              "pipelines.experiments", "ops.attention", "utils.logging",
              "utils.checkpoint", "train.train", "train.loop",
              "models.sam.encoder", "models.sam.decoder", "models.sam.model",
              "pipelines.segment", "pipelines.analysis", "native",
              "gallery.capacity", "gallery.persist", "gallery.planes",
              "parallel.mesh", "parallel.multihost", "gallery.sharded",
              "gallery.store", "gallery.server", "gallery.qdrant_compat",
              "gallery.client", "gallery.router", "pipelines.migrate",
              "utils.download", "ops.image", "models.detector.saliency",
              "pipelines.labeling", "pipelines.crop", "pipelines.augment",
              "pipelines.ingest", "models.yolo.model", "models.yolo.convert",
              "models.yolo.download", "models.yolo.detector",
              "models.detector.tinydet", "train.detector_loop"):
        assert p + m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'retrieval_based_object_detection_tpu' "
        "or m.startswith('retrieval_based_object_detection_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_imports_without_jax_and_builds_nothing():
    """Importing the chip smoke script loads the port and no JAX, and does
    not start its run (that waits for ``__main__``)."""
    code = (
        "import sys, runpy\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke_import')\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or "
        "m.startswith('retrieval_based_object_detection_tpu.') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_gpu():
    """With no visible card the script exits non-zero and prints no result
    line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    """Copied away from the checkout, the script finds no port: it exits
    non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode != 0
    assert "not importable" in res.stderr
    assert '"ok": true' not in res.stdout
