"""TinyDet: trainable anchor-free single-stage detector (FCOS-style).

Fills the YOLO slot of the labeling stage (11_dataset_labeling.py:96-99,
159) for deployments that train on their own product data instead of the
weight-free saliency proposer, and serves as ``RetrievalDetector``'s
external detector. Fixed input size, one stride-16 feature map, dense
per-cell predictions, static-K decode with an O(K²) vectorised greedy NMS.

Architecture: 4 stride-2 conv stages (LayerNorm + GELU) → head with two
1×1 branches: objectness logit and LTRB distances (softplus-scaled). Loss:
sigmoid focal loss on objectness (positives = cells inside a GT box) +
IoU loss at positive cells.

The port keeps the JAX package's functional form: parameters are a dict
of tensors in its layout (HWIO kernels), images NHWC. Where the two
frameworks' defaults differ it follows JAX: "SAME" padding puts the
smaller half low on the stride-2 convs (XLA's rule, not
``nn.Conv2d(padding=1)``), GELU is the tanh approximation
(``jax.nn.gelu``'s default), the LayerNorm is over channels with the
population variance and eps 1e-6, and ``top_k`` ties keep the lower index.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TinyDetConfig:
    image_size: int = 256
    channels: tuple[int, ...] = (32, 64, 128, 256)
    head_dim: int = 128
    max_det: int = 16

    @property
    def stride(self) -> int:
        return 2 ** len(self.channels)

    @property
    def grid(self) -> int:
        return self.image_size // self.stride


def init_params(config: TinyDetConfig = TinyDetConfig(), seed: int = 0
                ) -> Params:
    """The JAX package's numpy init (the same numbers for the same seed),
    as numpy arrays; ``params_from_jax`` puts them on a device."""
    rng = np.random.default_rng(seed)

    def conv(cin, cout, k):
        std = (k * k * cin) ** -0.5
        return {
            "kernel": rng.normal(0, std, (k, k, cin, cout)).astype(np.float32),
            "bias": np.zeros(cout, np.float32),
            "ln_scale": np.ones(cout, np.float32),
            "ln_bias": np.zeros(cout, np.float32),
        }

    chans = config.channels
    return {
        "stages": [conv(3 if i == 0 else chans[i - 1], chans[i], 3)
                   for i in range(len(chans))],
        "head_conv": conv(chans[-1], config.head_dim, 3),
        "obj": {
            "kernel": rng.normal(0, config.head_dim ** -0.5,
                                 (1, 1, config.head_dim, 1)).astype(np.float32),
            # Bias init so initial objectness ~ 1% (focal-loss convention).
            "bias": np.full(1, -4.59, np.float32),
        },
        "ltrb": {
            "kernel": rng.normal(0, config.head_dim ** -0.5,
                                 (1, 1, config.head_dim, 4)).astype(np.float32),
            "bias": np.zeros(4, np.float32),
        },
    }


def params_from_jax(params, device: str | torch.device = "cuda") -> Params:
    """A parameter tree of numpy or jax arrays (``init_params``, or JAX's
    trained params) → the same tree of f32 tensors on ``device``."""
    dev = resolve_device(device)

    def walk(p):
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [walk(v) for v in p]
        if isinstance(p, torch.Tensor):
            return p.detach().to(device=dev, dtype=torch.float32).clone()
        return torch.tensor(np.asarray(p, np.float32), device=dev)

    return walk(params)


def leaves(params: Params) -> list[torch.Tensor]:
    """The tensors of a tree in a fixed order (stages, head, obj, ltrb)."""
    out = []
    for p in params["stages"] + [params["head_conv"]]:
        out += [p["kernel"], p["bias"], p["ln_scale"], p["ln_bias"]]
    for name in ("obj", "ltrb"):
        out += [params[name]["kernel"], params[name]["bias"]]
    return out


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """XLA's "SAME" padding of NCHW ``x`` for a k×k window: the total pad
    split with the smaller half low."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W, then H
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """NCHW conv with an HWIO kernel and "SAME" padding, no bias."""
    k = kernel.shape[0]
    return F.conv2d(_same_pad(x, k, stride), kernel.permute(3, 2, 0, 1),
                    stride=stride)


def _conv_ln_gelu(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    x = _conv(x, p["kernel"], stride) + p["bias"][:, None, None]
    mean = torch.mean(x, dim=1, keepdim=True)
    var = torch.var(x, dim=1, keepdim=True, correction=0)
    x = (x - mean) * torch.rsqrt(var + 1e-6)
    x = x * p["ln_scale"][:, None, None] + p["ln_bias"][:, None, None]
    return F.gelu(x, approximate="tanh")


def forward(params: Params, images: torch.Tensor,
            config: TinyDetConfig = TinyDetConfig()
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, S, S, 3] 0..255 → (obj_logits [B, g, g], ltrb [B, g, g, 4] px)."""
    x = images.to(torch.float32).permute(0, 3, 1, 2) / 127.5 - 1.0
    for p in params["stages"]:
        x = _conv_ln_gelu(x, p, 2)
    x = _conv_ln_gelu(x, params["head_conv"], 1)
    obj = _conv(x, params["obj"]["kernel"], 1)[:, 0] \
        + params["obj"]["bias"][0]
    ltrb = _conv(x, params["ltrb"]["kernel"], 1).permute(0, 2, 3, 1) \
        + params["ltrb"]["bias"]
    ltrb = torch.logaddexp(ltrb, torch.zeros_like(ltrb)) * config.stride
    return obj, ltrb


def _cell_centers(g: int, stride: int, device) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    r = (torch.arange(g, dtype=torch.float32, device=device) + 0.5) * stride
    return r[None, :].expand(g, g), r[:, None].expand(g, g)  # xs, ys


@torch.no_grad()
def decode(
    params: Params,
    images: torch.Tensor,
    config: TinyDetConfig = TinyDetConfig(),
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (boxes [B, max_det, 4] xyxy px, scores [B, max_det]).

    conf_threshold defaults to the reference's 0.25
    (11_dataset_labeling.py:159); suppressed/empty slots score 0.
    """
    obj, ltrb = forward(params, images, config)
    B, g = obj.shape[0], obj.shape[1]
    xs, ys = _cell_centers(g, config.stride, obj.device)
    boxes = torch.stack([
        xs[None] - ltrb[..., 0], ys[None] - ltrb[..., 1],
        xs[None] + ltrb[..., 2], ys[None] + ltrb[..., 3],
    ], dim=-1)
    boxes = torch.clamp(boxes, 0.0, float(config.image_size))
    scores = torch.sigmoid(obj).reshape(B, g * g)
    boxes = boxes.reshape(B, g * g, 4)

    K = config.max_det
    # lax.top_k keeps the lower index on ties: a stable descending sort.
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :K], top_idx[:, :K]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_scores = torch.where(top_scores >= conf_threshold, top_scores, 0.0)

    # Vectorised greedy NMS over the K candidates, JAX's K-step loop: j > i
    # is suppressed only by a kept i.
    iou = _pairwise_iou(top_boxes, top_boxes)  # [B, K, K]
    later = torch.arange(K, device=iou.device)
    keep = top_scores > 0.0
    for i in range(K):
        sup = (iou[:, i] > iou_threshold) & keep[:, i:i + 1] & \
            (later[None, :] > i)
        keep = keep & ~sup
    return top_boxes, torch.where(keep, top_scores, 0.0)


def _pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., K, 4] x [..., K, 4] → [..., K, K] IoU."""
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


# ------------------------------------------------------------ training
def loss_fn(params, images, gt_boxes, gt_valid, config: TinyDetConfig):
    """Focal objectness + IoU box loss.

    gt_boxes [B, M, 4] xyxy px, gt_valid [B, M] bool (padded GT slots).
    """
    obj, ltrb = forward(params, images, config)
    g = obj.shape[1]
    xs, ys = _cell_centers(g, config.stride, obj.device)

    # Cell (x, y) positive iff inside any valid GT box.
    inside = (
        (xs[None, :, :, None] >= gt_boxes[:, None, None, :, 0]) &
        (xs[None, :, :, None] < gt_boxes[:, None, None, :, 2]) &
        (ys[None, :, :, None] >= gt_boxes[:, None, None, :, 1]) &
        (ys[None, :, :, None] < gt_boxes[:, None, None, :, 3]) &
        gt_valid[:, None, None, :]
    )  # [B, g, g, M]
    pos = torch.any(inside, dim=-1)
    # Each positive cell regresses to the first box containing it.
    first = torch.argmax(inside.to(torch.uint8), dim=-1)  # [B, g, g]
    tgt = torch.gather(
        gt_boxes[:, None, None, :, :].expand(-1, g, g, -1, -1), 3,
        first[..., None, None].expand(-1, -1, -1, 1, 4))[..., 0, :]

    # Focal BCE on objectness.
    p = torch.sigmoid(obj)
    t = pos.to(torch.float32)
    pt = p * t + (1 - p) * (1 - t)
    alpha = 0.25 * t + 0.75 * (1 - t)
    bce = -torch.log(torch.clamp(pt, min=1e-6))
    focal = torch.mean(alpha * (1 - pt) ** 2 * bce)

    # IoU loss at positive cells.
    pred = torch.stack([
        xs[None] - ltrb[..., 0], ys[None] - ltrb[..., 1],
        xs[None] + ltrb[..., 2], ys[None] + ltrb[..., 3],
    ], dim=-1)
    zero = torch.zeros((), device=pred.device)
    lt = torch.maximum(pred[..., :2], tgt[..., :2])
    rb = torch.minimum(pred[..., 2:], tgt[..., 2:])
    wh = torch.maximum(rb - lt, zero)
    inter = wh[..., 0] * wh[..., 1]
    area_p = torch.maximum(pred[..., 2] - pred[..., 0], zero) * \
        torch.maximum(pred[..., 3] - pred[..., 1], zero)
    area_t = torch.maximum(tgt[..., 2] - tgt[..., 0], zero) * \
        torch.maximum(tgt[..., 3] - tgt[..., 1], zero)
    iou = inter / torch.clamp(area_p + area_t - inter, min=1e-6)
    n_pos = torch.clamp(torch.sum(pos).to(torch.float32), min=1.0)
    iou_loss = torch.sum(torch.where(pos, 1.0 - iou, 0.0)) / n_pos
    return focal * 10.0 + iou_loss, {"focal": focal, "iou_loss": iou_loss,
                                     "n_pos": n_pos}


def make_train_step(config: TinyDetConfig, learning_rate: float = 1e-3):
    """→ (step, init): ``init(params)`` makes the optimizer state (Adam,
    optax.adam's defaults) over the tree's tensors, which it marks as
    trainable; ``step(params, opt_state, images, gt_boxes, gt_valid)``
    updates them in place and returns (params, opt_state, metrics)."""

    def init(params):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        return torch.optim.Adam(ps, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)

    def step(params, opt_state, images, gt_boxes, gt_valid):
        dev = params["obj"]["bias"].device
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
        gt_boxes = torch.as_tensor(gt_boxes, dtype=torch.float32, device=dev)
        gt_valid = torch.as_tensor(gt_valid, dtype=torch.bool, device=dev)
        opt_state.zero_grad(set_to_none=True)
        loss, aux = loss_fn(params, images, gt_boxes, gt_valid, config)
        loss.backward()
        opt_state.step()
        return params, opt_state, {"loss": loss.detach(),
                                   **{k: v.detach() for k, v in aux.items()}}

    return step, init
