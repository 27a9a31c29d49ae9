"""The device side of a run: cache directories inside the checkout, the
card check, the device block of the result line, and the check that no
JAX module was loaded."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

# Compared by whole top-level name: the port's own package name begins
# with the JAX package's, and is allowed.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax",
                     "retrieval_based_object_detection_tpu")


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX
    package."""
    names = {m.split(".")[0] for m in (modules or list(sys.modules))}
    return sorted(names & set(FORBIDDEN_MODULES))


def set_cache_dirs(checkout: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a cell's first run there builds. The port's nvcc builds
    already go to ``<checkout>/build/kernels``."""
    cache = Path(checkout) / "build" / "port_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    # transformers and friends would otherwise load JAX by themselves.
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def host_threads(torch) -> None:
    """One intra-op thread for the port's tensor operations on the host.
    The process already runs the server's handlers, the micro-batcher,
    the loader's decode pool or the callers on the machine's few cores;
    an intra-op pool of one thread a core beside them competes with them
    and makes the runs of a cell spread."""
    torch.set_num_threads(1)


def require_cuda(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, "
                       f"{torch.cuda.device_count()} present")


def device_block(torch, device, chips: int) -> dict:
    """The result line's ``device`` for a run on ``device``: the peak is
    that of the fullest card. A run on the CPU (the CPU tests) reads no
    card."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def card_note() -> str:
    """The card's name and power limit, for the log lines."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        out.stderr.strip()
