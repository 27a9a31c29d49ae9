"""Official YOLOv8 checkpoint → the port's ``YoloV8`` module.

The reference's labeling stage loads ``model/yolov8s.pt``
(11_dataset_labeling.py:10, 96-99) — an ultralytics training container:
a torch pickle whose ``"model"`` entry is a full ``DetectionModel``
MODULE OBJECT, so a plain ``torch.load`` needs the ultralytics package
installed just to unpickle it. This loader does not: a stub unpickler
materialises any unresolvable ``ultralytics.*`` class as an inert
state-holder, then the module graph is walked (``_modules`` /
``_parameters`` / ``_buffers``) to reconstruct the flat ``model.{i}.…``
state dict. Plain ``state_dict()`` saves and ``{"model": state_dict}``
containers load too.

``YoloV8`` carries the official module names, so conversion is a load by
name (``num_batches_tracked`` dropped). Config (variant width/depth, class
count, reg_max) is INFERRED from weight shapes, so any v8 detect variant
(n/s/m/l/x, custom nc) converts without being told which it is. The
container loading and the inference are host code copied from the JAX
package's ``models/yolo/convert.py``.
"""

from __future__ import annotations

import io
import pickle
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.models.yolo.model import (
    SPEC,
    VARIANTS,
    YoloConfig,
    YoloV8,
    build_model,
)


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


# ----------------------------------------------------- container loading
class _Stub:
    """Inert stand-in for an unimportable (ultralytics) class: accepts
    any pickled state, exposes it as attributes."""

    def __init__(self, *a, **kw):  # some classes pickle with ctor args
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


class _StubPickleModule:
    """pickle_module shim for torch.load: resolve what imports, stub the
    rest (the ultralytics model/trainer classes in official .pt files)."""

    Unpickler = _StubUnpickler

    @staticmethod
    def load(f, **kw):
        return _StubUnpickler(f, **kw).load()

    @staticmethod
    def loads(data, **kw):
        return _StubUnpickler(io.BytesIO(data), **kw).load()


def _walk_module(obj, prefix: str, out: dict) -> None:
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return
    for k, v in (d.get("_parameters") or {}).items():
        if v is not None:
            out[prefix + k] = v
    for k, v in (d.get("_buffers") or {}).items():
        if v is not None:
            out[prefix + k] = v
    for k, v in (d.get("_modules") or {}).items():
        if v is not None:
            _walk_module(v, f"{prefix}{k}.", out)


def load_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """Torch checkpoint → flat ``model.{i}.…`` → ndarray state dict.
    Accepts the official ultralytics container (module object under
    "model"), ``{"model": state_dict}``, or a bare state_dict."""
    obj = torch.load(str(path), map_location="cpu", weights_only=False,
                     pickle_module=_StubPickleModule)
    if isinstance(obj, Mapping) and "model" in obj:
        obj = obj["model"]
    if isinstance(obj, Mapping):          # plain state_dict
        sd = dict(obj)
    else:                                 # (stubbed) module object
        sd = {}
        _walk_module(obj, "", sd)
        if not sd:
            raise ValueError(
                f"{path}: unpickled container has no module state — not "
                "an ultralytics detection checkpoint?")
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        out[k] = _np(v)
    if not any(k.startswith("model.0.conv") for k in out):
        raise ValueError(
            f"{path}: no 'model.0.conv.*' keys — expected the YOLOv8 "
            f"detect layout (got e.g. {sorted(out)[:3]})")
    return out


def infer_config(sd: Mapping[str, np.ndarray]) -> YoloConfig:
    """Variant geometry from weight shapes alone."""
    det = len(SPEC) - 1
    nc = sd[f"model.{det}.cv3.0.2.weight"].shape[0]
    reg4 = sd[f"model.{det}.cv2.0.2.weight"].shape[0]
    stem = sd["model.0.conv.weight"].shape[0]        # ch(64) = 64·w
    width = stem / 64.0
    # Depth from the first backbone C2f's bottleneck count: n(3).
    n2 = 0
    while f"model.2.m.{n2}.cv1.conv.weight" in sd:
        n2 += 1
    depth = n2 / 3.0
    # max_channels from the P5 conv: ch(1024) = min(1024, mc)·w.
    p5 = sd["model.7.conv.weight"].shape[0]
    mc = int(round(p5 / width))
    for cfg in VARIANTS.values():
        if (abs(cfg.width_mult - width) < 1e-6
                and cfg.n(3) == n2 and cfg.max_channels == mc):
            return YoloConfig(cfg.depth_mult, cfg.width_mult, mc,
                              num_classes=nc, reg_max=reg4 // 4)
    return YoloConfig(depth, width, mc, num_classes=nc,
                      reg_max=reg4 // 4)


def convert_state_dict(sd: Mapping[str, np.ndarray],
                       device: str | torch.device = "cuda"
                       ) -> tuple[YoloV8, YoloConfig]:
    """A flat official state dict (``load_state_dict``) → (``YoloV8`` in
    eval mode on ``device``, its inferred config)."""
    config = infer_config(sd)
    state = {k: torch.tensor(np.ascontiguousarray(v, np.float32))
             for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    return build_model(state, config, device=device), config


def load_torch_checkpoint(path: str | Path,
                          device: str | torch.device = "cuda"
                          ) -> tuple[YoloV8, YoloConfig]:
    """Official ``yolov8*.pt`` (or a state_dict save) → (module, config)."""
    return convert_state_dict(load_state_dict(path), device=device)
