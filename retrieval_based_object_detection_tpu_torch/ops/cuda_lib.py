"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout (a directory git ignores) and bound with ``ctypes``. The
library's file name carries a hash of its source, of every shared header
(``csrc/*.cuh``) and of the flags, so an edited source or header is never
served by a stale build. Nothing is compiled or loaded when
a module is imported: the CPU tests import every module and have no nvcc.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
binding raises on anything but 0, because a refused launch (too much shared
memory, a bad grid) never runs and a later synchronise does not report it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# Dynamic shared memory one block may use on sm_90 (227 KB).
MAX_SMEM = 232_448


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA toolkit is needed to build the "
            f"kernels in {CSRC}")
    return path


class CudaLibrary:
    """One kernel source, its shared library, and its launch count.

    ``functions`` maps each exported C function to its ctypes argument
    types (pointers and the stream as ``c_void_p``: a bare Python int
    would be passed as a 32-bit int and cut the pointer). ``launches``
    counts the kernel's runs: successful launches through :meth:`launch`,
    and the replays of CUDA graphs that recorded them (:meth:`replayed`);
    ``counts`` splits them by exported function, for sources that hold
    more than one kernel. A launch made while the current stream captures
    a graph runs at the graph's replays, not then: ``recorded`` counts it.
    :meth:`reset_counts` zeroes all three.
    """

    def __init__(self, name: str, functions: dict[str, list]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.functions = functions
        self.launches = 0
        self.counts = dict.fromkeys(functions, 0)
        self.recorded = dict.fromkeys(functions, 0)
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    @functools.cached_property
    def path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{digest.hexdigest()[:16]}.so"

    def start_build(self) -> tuple[subprocess.Popen, Path] | None:
        """Start ``nvcc`` for this source unless the library is built;
        returns the process and its temporary output."""
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started: tuple[subprocess.Popen, Path] | None
                     ) -> None:
        if started is None:
            return
        proc, tmp = started
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {self.source} (exit {proc.returncode}):\n"
                f"{out}")
        os.replace(tmp, self.path)  # atomic: concurrent builders agree

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.path))
                for fn, argtypes in self.functions.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def launch(self, fn: str, device: torch.device, *args) -> None:
        """Call one exported launcher on ``device``, with that card current
        (the C launchers launch on the current card) and its current
        stream appended to ``args``; raise on a CUDA error, else count."""
        lib = self.load()
        with torch.cuda.device(device):
            capturing = torch.cuda.is_current_stream_capturing()
            rc = getattr(lib, fn)(
                *args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            msg = lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}: {msg}")
        with self._lock:
            if capturing:
                self.recorded[fn] += 1
            else:
                self.launches += 1
                self.counts[fn] += 1

    def replayed(self, recorded: dict[str, int]) -> None:
        """Count the runs of one replay of a graph that recorded
        ``recorded`` launches (function → launches)."""
        with self._lock:
            for fn, n in recorded.items():
                self.launches += n
                self.counts[fn] += n

    def reset_counts(self) -> None:
        with self._lock:
            self.launches = 0
            self.counts = dict.fromkeys(self.functions, 0)
            self.recorded = dict.fromkeys(self.functions, 0)


def build_all(libraries: list[CudaLibrary]) -> None:
    """Build every library that is not built yet, one ``nvcc`` per source,
    all started together, then load them."""
    started = [(lib, lib.start_build()) for lib in libraries]
    errors = []
    for lib, s in started:  # wait for every nvcc before raising
        try:
            lib.finish_build(s)
        except RuntimeError as e:
            errors.append(e)
    if errors:
        raise errors[0]
    for lib in libraries:
        lib.load()
