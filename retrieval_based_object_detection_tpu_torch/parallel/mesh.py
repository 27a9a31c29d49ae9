"""Device-mesh helpers.

Axes used by the framework:
  dp      — data parallel over image batches (embedding/training)
  tp      — tensor parallel over the CLIP tower's hidden dims
  gallery — row-sharding of the vector gallery for distributed top-k

A ``Mesh`` here is an array of ``torch.device``s with named axes: the
sharded gallery tier (``gallery/sharded.py``) places one shard of rows on
each device along the ``gallery`` axis and runs its scan there. A device may
appear more than once: four shards on one card run the sharded tier's logic
and its per-shard kernels on that card (one after another on its stream),
and the CPU tests put eight shards on the one CPU device.
"""

from __future__ import annotations

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


class Mesh:
    """Devices laid out on named axes. ``shape`` maps each axis name to its
    size, in axis order."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, name: str) -> list[torch.device]:
        """The devices along axis ``name`` with every other axis at index
        0: one per shard of a tensor split over that axis alone."""
        if name not in self.axis_names:
            raise ValueError(f"mesh has no {name!r} axis: {self.shape}")
        pos = self.axis_names.index(name)
        index = tuple(slice(None) if i == pos else 0
                      for i in range(len(self.axis_names)))
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def device_count(device: str | torch.device = "cuda") -> int:
    """Visible devices of ``device``'s type: the CUDA cards, or 1 for the
    CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _all_devices(device: str | torch.device) -> list[torch.device]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(device_count(dev))]
    return [dev]


def make_mesh(axis_sizes: dict[str, int] | None = None,
              devices: list | None = None) -> Mesh:
    """Build a mesh with named axes; sizes must multiply to #devices.

    ``make_mesh({"dp": 2, "tp": 4})`` → 2x4 mesh over the first eight
    visible cards. With ``axis_sizes`` None, all devices go on a single
    ``dp`` axis. ``devices`` may list a device more than once
    (``make_mesh({"gallery": 4}, ["cuda:0"] * 4)``)."""
    devices = ([resolve_device(d) for d in devices] if devices is not None
               else _all_devices("cuda"))
    if axis_sizes is None:
        axis_sizes = {"dp": len(devices)}
    names = tuple(axis_sizes)
    sizes = tuple(int(s) for s in axis_sizes.values())
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(
            f"mesh sizes {axis_sizes} do not multiply to {len(devices)} "
            "devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), names)


def gallery_mesh(n_shards: int | None = None,
                 device: str | torch.device = "cuda") -> Mesh:
    """1-D mesh over the gallery axis. On CUDA: the first ``n_shards``
    visible cards (all of them by default), and an error past
    ``torch.cuda.device_count()``. On the CPU: ``n_shards`` shards of the
    one CPU device (1 by default)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return make_mesh({"gallery": n_shards or 1}, [dev] * (n_shards or 1))
    devices = _all_devices(dev)
    n = n_shards or len(devices)
    if n > len(devices):
        raise ValueError(f"{n} gallery shards asked for, {len(devices)} "
                         "CUDA devices visible")
    return make_mesh({"gallery": n}, devices[:n])
