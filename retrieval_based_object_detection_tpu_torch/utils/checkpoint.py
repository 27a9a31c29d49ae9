"""Parameter and train-state checkpoints, in the port's own format.

The JAX package checkpoints through orbax; orbax directories cannot be
read without JAX, so the port writes its own: ``torch.save`` of a nested
dict of tensors (and plain numbers), each file written to a temporary name
and renamed into place, so a reader sees a whole checkpoint or none. To
carry weights from the JAX package across, load them there and convert
the numpy pytree with the port's ``params_from_jax``.

``TrainCheckpointer`` keeps step-numbered directories ``<root>/<step>/``
holding ``state.pt``, keeps the ``keep`` newest and finds ``latest_step``
for resuming interrupted training.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any

import torch

STATE_FILE = "state.pt"


def _save_atomic(obj: Any, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_params(params: Any, path: str | Path) -> None:
    """Write ``params`` (a nested dict of tensors) to the file ``path``."""
    _save_atomic(params, Path(path).resolve())


def load_params(path: str | Path,
                map_location: str | torch.device | None = "cpu") -> Any:
    return torch.load(Path(path).resolve(), map_location=map_location,
                      weights_only=True)


class TrainCheckpointer:
    """Step-numbered train-state checkpoints with resume support."""

    def __init__(self, root: str | Path, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be at least 1, got {keep}")
        self.root = Path(root).resolve()
        self.keep = keep

    def all_steps(self) -> list[int]:
        """Ascending steps that hold a complete checkpoint."""
        if not self.root.is_dir():
            return []
        return sorted(int(d.name) for d in self.root.iterdir()
                      if d.name.isdigit() and (d / STATE_FILE).is_file())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as step ``step``, then drop all but the ``keep``
        newest steps."""
        _save_atomic(state, self.root / str(step) / STATE_FILE)
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.root / str(old), ignore_errors=True)

    def restore(self, step: int | None = None,
                map_location: str | torch.device | None = "cpu") -> Any:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return torch.load(self.root / str(step) / STATE_FILE,
                          map_location=map_location, weights_only=True)
