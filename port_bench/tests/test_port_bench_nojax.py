"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Each check runs in a fresh
interpreter and compares whole top-level module names: the port's name
begins with the JAX package's."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

PRELUDE = f"""
import json, sys, importlib.util
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
def load(rel):
    spec = importlib.util.spec_from_file_location(
        "m" + str(abs(hash(rel))), {str(BENCH)!r} + "/" + rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
"""


def top_level_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", PRELUDE + code +
         "\nprint(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


FORBIDDEN = {"jax", "jaxlib", "flax", "retrieval_based_object_detection_tpu"}
PORT = "retrieval_based_object_detection_tpu_torch"


def test_harness_loads_no_jax():
    names = top_level_after("""
load("run.py"); load("control.py"); load("sweep.py")
from benchcore import spec
for kind in ("detect_http", "search_inproc", "embed_tree"):
    spec.traffic(kind)
spec.metrics()
import reference.clip, reference.detect, reference.search, reference.embed
import retrieval_based_object_detection_tpu_torch.pipelines.serve
import retrieval_based_object_detection_tpu_torch.pipelines.embed
import retrieval_based_object_detection_tpu_torch.pipelines.delegates
import retrieval_based_object_detection_tpu_torch.gallery.store
""")
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert PORT in names


def test_reference_loads_nothing_of_the_port():
    names = top_level_after("""
import reference.clip, reference.detect, reference.search, reference.embed
""")
    assert not names & (FORBIDDEN | {PORT}), names & (FORBIDDEN | {PORT})


def test_the_run_check_names_what_it_finds():
    from benchcore.device import forbidden_loaded

    assert forbidden_loaded([PORT, PORT + ".gallery", "numpy"]) == []
    assert forbidden_loaded(["jax.numpy", "flax", PORT]) == ["flax", "jax"]
    assert forbidden_loaded(
        ["retrieval_based_object_detection_tpu.ops"]) == [
            "retrieval_based_object_detection_tpu"]
