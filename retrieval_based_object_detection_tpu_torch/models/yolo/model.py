"""YOLOv8 detection graph in PyTorch — the reference's auto-label model.

The reference labels every image with pretrained ``model/yolov8s.pt`` at
conf 0.25, keeping top-K boxes by confidence
(11_dataset_labeling.py:10, 96-99, 159, 178-180). ``YoloV8`` is the v8
detect architecture with the official checkpoint's module names
(``model.{i}.…``), so an official state dict loads into it by name.
Inside, it runs NCHW; its public functions take and return the JAX
package's NHWC arrays. The DFL decode runs on the device; NMS is host
NumPy (tiny K, data-dependent control flow), copied from the JAX package.

Architecture (ultralytics v8 detect layout, all variants n/s/m/l/x by
depth/width multiples): CSPDarknet backbone (Conv stem → C2f stages →
SPPF) + PAN-FPN neck (upsample/concat C2f, downsample Convs) + decoupled
head per stride {8, 16, 32}: a box branch emitting 4×reg_max DFL logits
and a class branch emitting nc logits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    """Static architecture description."""
    depth_mult: float = 0.33          # yolov8s
    width_mult: float = 0.50
    max_channels: int = 1024
    num_classes: int = 80
    reg_max: int = 16
    strides: tuple[int, ...] = (8, 16, 32)

    def ch(self, c: int) -> int:
        """make_divisible(min(c, max_channels) * width, 8)."""
        return max(8, int(
            math.ceil(min(c, self.max_channels) * self.width_mult / 8) * 8))

    def n(self, n: int) -> int:
        return max(1, round(n * self.depth_mult))


# The named variants (ultralytics yolov8.yaml scales).
VARIANTS: dict[str, YoloConfig] = {
    "yolov8n": YoloConfig(0.33, 0.25, 1024),
    "yolov8s": YoloConfig(0.33, 0.50, 1024),
    "yolov8m": YoloConfig(0.67, 0.75, 768),
    "yolov8l": YoloConfig(1.00, 1.00, 512),
    "yolov8x": YoloConfig(1.00, 1.25, 512),
}

# (kind, args) per torch module index. conv: (c_out, k, stride);
# c2f: (c_out, base_repeats, shortcut); concat: source layer index
# (plus the running tensor); detect: the three feature layer indices.
SPEC: tuple = (
    ("conv", 64, 3, 2),        # 0  P1/2
    ("conv", 128, 3, 2),       # 1  P2/4
    ("c2f", 128, 3, True),     # 2
    ("conv", 256, 3, 2),       # 3  P3/8
    ("c2f", 256, 6, True),     # 4
    ("conv", 512, 3, 2),       # 5  P4/16
    ("c2f", 512, 6, True),     # 6
    ("conv", 1024, 3, 2),      # 7  P5/32
    ("c2f", 1024, 3, True),    # 8
    ("sppf", 1024, 5),         # 9
    ("upsample",),             # 10
    ("concat", 6),             # 11
    ("c2f", 512, 3, False),    # 12
    ("upsample",),             # 13
    ("concat", 4),             # 14
    ("c2f", 256, 3, False),    # 15 (P3 head in)
    ("conv", 256, 3, 2),       # 16
    ("concat", 12),            # 17
    ("c2f", 512, 3, False),    # 18 (P4 head in)
    ("conv", 512, 3, 2),       # 19
    ("concat", 9),             # 20
    ("c2f", 1024, 3, False),   # 21 (P5 head in)
    ("detect", (15, 18, 21)),  # 22
)

_SAVED = {4, 6, 9, 12} | set(SPEC[-1][1])


# ------------------------------------------------------------------ init
def _init_conv(rng, c_in, c_out, k) -> dict:
    w = rng.normal(size=(k, k, c_in, c_out)).astype(np.float32)
    w *= 1.0 / np.sqrt(k * k * c_in)
    return {"w": w,
            "bn": {"gamma": np.ones(c_out, np.float32),
                   "beta": np.zeros(c_out, np.float32),
                   "mean": np.zeros(c_out, np.float32),
                   "var": np.ones(c_out, np.float32)}}


def _init_c2f(rng, c_in, c_out, n) -> dict:
    c = c_out // 2
    return {
        "cv1": _init_conv(rng, c_in, 2 * c, 1),
        "cv2": _init_conv(rng, (2 + n) * c, c_out, 1),
        "m": [{"cv1": _init_conv(rng, c, c, 3),
               "cv2": _init_conv(rng, c, c, 3)} for _ in range(n)],
    }


def init_params(config: YoloConfig, seed: int = 0) -> list:
    """Random-init param list in the JAX package's layout (HWIO kernels),
    one entry per SPEC index: the same numbers as its ``init_params`` for
    the same seed. Load it with ``params_from_jax``."""
    rng = np.random.default_rng(seed)
    ch: list[int] = []   # output channels per layer
    params: list = []
    c_prev = 3
    for spec in SPEC:
        kind = spec[0]
        if kind == "conv":
            c_out = config.ch(spec[1])
            params.append(_init_conv(rng, c_prev, c_out, spec[2]))
            c_prev = c_out
        elif kind == "c2f":
            c_out = config.ch(spec[1])
            params.append(_init_c2f(rng, c_prev, c_out, config.n(spec[2])))
            c_prev = c_out
        elif kind == "sppf":
            c_out = config.ch(spec[1])
            c_h = c_prev // 2
            params.append({"cv1": _init_conv(rng, c_prev, c_h, 1),
                           "cv2": _init_conv(rng, c_h * 4, c_out, 1)})
            c_prev = c_out
        elif kind == "upsample":
            params.append({})
        elif kind == "concat":
            params.append({})
            c_prev = c_prev + ch[spec[1]]
        elif kind == "detect":
            srcs = spec[1]
            chs = [ch[i] for i in srcs]
            c2 = max(16, chs[0] // 4, config.reg_max * 4)
            c3 = max(chs[0], min(config.num_classes, 100))
            det = {"cv2": [], "cv3": [],
                   "dfl": np.arange(config.reg_max,
                                    dtype=np.float32).reshape(
                       1, 1, config.reg_max, 1)}
            for c_in in chs:
                det["cv2"].append([
                    _init_conv(rng, c_in, c2, 3),
                    _init_conv(rng, c2, c2, 3),
                    {"w": rng.normal(size=(1, 1, c2, 4 * config.reg_max)
                                     ).astype(np.float32) / np.sqrt(c2),
                     "b": np.ones(4 * config.reg_max, np.float32)},
                ])
                det["cv3"].append([
                    _init_conv(rng, c_in, c3, 3),
                    _init_conv(rng, c3, c3, 3),
                    {"w": rng.normal(size=(1, 1, c3, config.num_classes)
                                     ).astype(np.float32) / np.sqrt(c3),
                     "b": np.full(config.num_classes, -5.0, np.float32)},
                ])
            params.append(det)
        else:  # pragma: no cover - spec is a closed set
            raise ValueError(kind)
        ch.append(c_prev)
    return params


# --------------------------------------------------------------- modules
class BatchNorm(nn.Module):
    """Inference batch norm with the official ``bn.*`` names (no
    ``num_batches_tracked``), applied as JAX applies it: one scale and
    one shift from ``rsqrt(var + 1e-3)``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + 1e-3)
        scale = (self.weight * inv).to(y.dtype)
        shift = (self.bias - self.running_mean * self.weight * inv
                 ).to(y.dtype)
        return y * scale[:, None, None] + shift[:, None, None]


class Conv(nn.Module):
    """conv (no bias) + BN (eps 1e-3) + SiLU, ``k // 2`` padding."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = BatchNorm(c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool):
        super().__init__()
        self.cv1 = Conv(c, c, 3)
        self.cv2 = Conv(c, c, 3)
        self.add = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, c1: int, c2: int, n: int, shortcut: bool):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, shortcut)
                               for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_ * 4, c2, 1)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # max_pool2d pads with -inf, as the JAX reduce_window does.
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(y, 1))


class DFL(nn.Module):
    """The DFL projection (official key ``dfl.conv.weight``: 0..reg_max-1)."""

    def __init__(self, reg_max: int):
        super().__init__()
        self.conv = nn.Conv2d(reg_max, 1, 1, bias=False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.arange(
                reg_max, dtype=torch.float32).view(1, reg_max, 1, 1))


class Detect(nn.Module):
    """Decoupled head: per scale, [4·reg_max box logits, nc class logits]."""

    def __init__(self, nc: int, reg_max: int, chs: list[int]):
        super().__init__()
        c2 = max(16, chs[0] // 4, reg_max * 4)
        c3 = max(chs[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(c, c2, 3), Conv(c2, c2, 3),
                          nn.Conv2d(c2, 4 * reg_max, 1)) for c in chs)
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(c, c3, 3), Conv(c3, c3, 3),
                          nn.Conv2d(c3, nc, 1)) for c in chs)
        self.dfl = DFL(reg_max)

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        return [torch.cat((self.cv2[i](f), self.cv3[i](f)), 1)
                for i, f in enumerate(feats)]


class YoloV8(nn.Module):
    """SPEC-composed YOLOv8 detect model with ultralytics module numbering:
    NCHW images 0..1 → per-stride raw heads, NCHW."""

    def __init__(self, config: YoloConfig):
        super().__init__()
        self.config = config
        layers: list[nn.Module] = []
        ch: list[int] = []
        c_prev = 3
        for spec in SPEC:
            kind = spec[0]
            if kind == "conv":
                c_out = config.ch(spec[1])
                layers.append(Conv(c_prev, c_out, spec[2], spec[3]))
                c_prev = c_out
            elif kind == "c2f":
                c_out = config.ch(spec[1])
                layers.append(C2f(c_prev, c_out, config.n(spec[2]),
                                  spec[3]))
                c_prev = c_out
            elif kind == "sppf":
                c_out = config.ch(spec[1])
                layers.append(SPPF(c_prev, c_out, spec[2]))
                c_prev = c_out
            elif kind in ("upsample", "concat"):
                layers.append(nn.Identity())
                if kind == "concat":
                    c_prev = c_prev + ch[spec[1]]
            elif kind == "detect":
                layers.append(Detect(config.num_classes, config.reg_max,
                                     [ch[i] for i in spec[1]]))
            ch.append(c_prev)
        self.model = nn.ModuleList(layers)

    @property
    def device(self) -> torch.device:
        return self.model[0].conv.weight.device

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        saved: dict[int, torch.Tensor] = {}
        for i, spec in enumerate(SPEC):
            kind = spec[0]
            if kind == "upsample":
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            elif kind == "concat":
                x = torch.cat([x, saved[spec[1]]], 1)
            elif kind == "detect":
                return self.model[i]([saved[s] for s in spec[1]])
            else:
                x = self.model[i](x)
            if i in _SAVED:
                saved[i] = x
        raise AssertionError("SPEC has no detect layer")  # pragma: no cover


# ------------------------------------------------------ weights, building
def _conv_sd(p: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.conv.weight"] = np.transpose(p["w"], (3, 2, 0, 1))
    bn = p["bn"]
    out[f"{prefix}.bn.weight"] = bn["gamma"]
    out[f"{prefix}.bn.bias"] = bn["beta"]
    out[f"{prefix}.bn.running_mean"] = bn["mean"]
    out[f"{prefix}.bn.running_var"] = bn["var"]


def params_from_jax(params: list) -> dict[str, torch.Tensor]:
    """The JAX package's param list (HWIO kernels, numpy or jax arrays) →
    a state dict for ``YoloV8`` (the official checkpoint's names)."""
    params = _to_numpy(params)
    out: dict[str, Any] = {}
    for i, spec in enumerate(SPEC):
        kind, p = spec[0], params[i]
        if kind == "conv":
            _conv_sd(p, f"model.{i}", out)
        elif kind == "c2f":
            _conv_sd(p["cv1"], f"model.{i}.cv1", out)
            _conv_sd(p["cv2"], f"model.{i}.cv2", out)
            for j, m in enumerate(p["m"]):
                _conv_sd(m["cv1"], f"model.{i}.m.{j}.cv1", out)
                _conv_sd(m["cv2"], f"model.{i}.m.{j}.cv2", out)
        elif kind == "sppf":
            _conv_sd(p["cv1"], f"model.{i}.cv1", out)
            _conv_sd(p["cv2"], f"model.{i}.cv2", out)
        elif kind == "detect":
            out[f"model.{i}.dfl.conv.weight"] = np.reshape(
                p["dfl"], (1, -1, 1, 1))
            for branch in ("cv2", "cv3"):
                for s, seq in enumerate(p[branch]):
                    _conv_sd(seq[0], f"model.{i}.{branch}.{s}.0", out)
                    _conv_sd(seq[1], f"model.{i}.{branch}.{s}.1", out)
                    out[f"model.{i}.{branch}.{s}.2.weight"] = np.transpose(
                        seq[2]["w"], (3, 2, 0, 1))
                    out[f"model.{i}.{branch}.{s}.2.bias"] = seq[2]["b"]
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return np.asarray(tree, np.float32)


def build_model(state_dict: dict[str, torch.Tensor], config: YoloConfig,
                device: str | torch.device = "cuda") -> YoloV8:
    """``YoloV8`` in eval mode on ``device`` with ``state_dict`` loaded
    (every key, nothing extra)."""
    model = YoloV8(config)
    model.load_state_dict(state_dict, strict=True)
    return model.to(resolve_device(device)).eval()


# --------------------------------------------------------------- forward
@torch.inference_mode()
def forward_features(model: YoloV8, images: torch.Tensor
                     ) -> list[torch.Tensor]:
    """images [B, H, W, 3] float 0..1 → per-stride raw heads
    [B, Hi, Wi, 4*reg_max + nc] (box DFL logits then class logits)."""
    x = images.to(device=model.device, dtype=model.model[0].conv.weight.dtype)
    heads = model(x.permute(0, 3, 1, 2))
    return [h.permute(0, 2, 3, 1) for h in heads]


@torch.inference_mode()
def predict(model: YoloV8, images: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W, 3] float 0..1 → (boxes [B, A, 4] xyxy px, class_probs
    [B, A, nc]) over all anchors A = Σ (H/s)(W/s), on the model's device.
    DFL decode: softmax (f32) over reg_max bins per side → expectation →
    ltrb cell distances → xyxy at the anchor's stride; anchors run stride
    by stride, row-major."""
    config = model.config
    heads = forward_features(model, images)
    rm, nc = config.reg_max, config.num_classes
    # f32 at least (f64 for a float64 model, as the card check runs one).
    acc = torch.promote_types(heads[0].dtype, torch.float32)
    dfl_w = model.model[-1].dfl.conv.weight.reshape(rm).to(acc)
    boxes_all, cls_all = [], []
    for head, stride in zip(heads, config.strides):
        B, H, W, _ = head.shape
        box = head[..., : 4 * rm].reshape(B, H * W, 4, rm)
        dist = torch.sum(torch.softmax(box.to(acc), dim=-1) * dfl_w,
                         dim=-1)                             # [B, HW, 4]
        dev = head.device
        ys = torch.arange(H, dtype=acc, device=dev) + 0.5
        xs = torch.arange(W, dtype=acc, device=dev) + 0.5
        cx = xs[None, :].expand(H, W).reshape(-1)
        cy = ys[:, None].expand(H, W).reshape(-1)
        x1 = (cx[None] - dist[..., 0]) * stride
        y1 = (cy[None] - dist[..., 1]) * stride
        x2 = (cx[None] + dist[..., 2]) * stride
        y2 = (cy[None] + dist[..., 3]) * stride
        boxes_all.append(torch.stack([x1, y1, x2, y2], dim=-1))
        cls_all.append(torch.sigmoid(head[..., 4 * rm:].to(acc)
                                     ).reshape(B, H * W, nc))
    return torch.cat(boxes_all, dim=1), torch.cat(cls_all, dim=1)


# ------------------------------------------------------------------- NMS
def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.45,
        max_det: int = 300) -> np.ndarray:
    """Host-side greedy NMS → kept indices (scores descending)."""
    order = np.argsort(-scores)
    keep: list[int] = []
    x1, y1, x2, y2 = boxes.T
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    while order.size and len(keep) < max_det:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = (np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0))
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def postprocess(boxes: np.ndarray, cls_probs: np.ndarray,
                conf_threshold: float = 0.25, iou_threshold: float = 0.45,
                max_det: int = 300, agnostic: bool = False
                ) -> list[dict]:
    """Per image: conf gate on the best class, per-class NMS (offset
    trick — ultralytics semantics), detections sorted by confidence.
    Returns [{"boxes": [K,4], "scores": [K], "classes": [K]}] per image.
    """
    out = []
    for b in range(boxes.shape[0]):
        conf = cls_probs[b].max(axis=1)
        cls = cls_probs[b].argmax(axis=1)
        m = conf >= conf_threshold
        bb, cc, kk = boxes[b][m], conf[m], cls[m]
        if bb.shape[0] == 0:
            out.append({"boxes": np.zeros((0, 4), np.float32),
                        "scores": np.zeros(0, np.float32),
                        "classes": np.zeros(0, np.int64)})
            continue
        off = (0 if agnostic
               else (kk[:, None] * (bb.max() + 1.0)).astype(np.float32))
        keep = nms(bb + off, cc, iou_threshold, max_det)
        out.append({"boxes": bb[keep].astype(np.float32),
                    "scores": cc[keep].astype(np.float32),
                    "classes": kk[keep]})
    return out
