"""Supervised fine-tuning of the CLIP tower with a classification head.

The reference never trains — it uses frozen CLIP zero-shot embeddings. A
production retrieval deployment fine-tunes the tower on the product
catalogue; this module gives the train step for that on one device:
images → CLIP tower (f32 master weights, bf16 or f32 compute) → linear or
cosine head → softmax cross-entropy, AdamW. The attention core of every
block runs kernel B1 forward and kernel B5 backward on the card
(``ops.clip_attention``). Data parallelism over several cards is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from retrieval_based_object_detection_tpu_torch.models.clip import (
    model as clip_model,
)
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_classes: int
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    compute_dtype: str = "bfloat16"
    # "linear": logits = emb @ W + b. "cosine": L2-normalise both the
    # embedding and the class weights and scale — cross-entropy then
    # optimises the cosine geometry the delegate search scores with.
    head: str = "linear"  # "linear" | "cosine"
    cosine_scale: float = 16.0
    # LR schedule: "constant" or "cosine" — linear warmup over
    # min(total_steps/10, 100) steps then cosine decay to lr/100 at
    # ``total_steps``. Requires total_steps > 0.
    lr_schedule: str = "constant"  # "constant" | "cosine"
    total_steps: int = 0
    # Recompute each tower block in the backward to trade FLOPs for
    # device memory.
    remat: bool = False


class Classifier(nn.Module):
    """The CLIP tower and a classification head ``{w, b}``: the JAX
    package's ``{"tower": ..., "head": ...}`` params as one module."""

    def __init__(self, tower: clip_model.CLIPVisionTower, w: torch.Tensor,
                 b: torch.Tensor):
        super().__init__()
        self.tower = tower
        self.head = nn.ParameterDict({"w": nn.Parameter(w),
                                      "b": nn.Parameter(b)})

    @property
    def device(self) -> torch.device:
        return self.head["w"].device

    def export(self) -> dict[str, dict[str, torch.Tensor]]:
        """Detached ``{"tower": state dict, "head": {"w", "b"}}``; the
        tower part loads with ``clip_model.build_tower``."""
        return {"tower": {k: v.detach()
                          for k, v in self.tower.state_dict().items()},
                "head": {k: v.detach() for k, v in self.head.items()}}


def _dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def init_state(
    clip_config: clip_model.CLIPVisionConfig,
    train_config: TrainConfig,
    seed: int = 0,
    params: Any | None = None,
    device: str | torch.device = "cuda",
) -> tuple[Classifier, "AdamW"]:
    """(model, optimizer). The tower comes from ``params`` (a state dict
    or a JAX-layout numpy pytree) or from ``init_params(seed)``; the head
    is ``w ~ N(0, embed_dim^-1/2)`` drawn from ``default_rng(seed + 1)``,
    ``b = 0`` — the JAX package's numbers for the same seed."""
    dev = resolve_device(device)
    state = params if params is not None else clip_model.init_params(
        clip_config, seed=seed)
    if "blocks" in state:
        state = clip_model.params_from_jax(state)
    tower = clip_model.CLIPVisionTower(
        clip_config, compute_dtype=_dtype(train_config.compute_dtype),
        remat=train_config.remat)
    tower.load_state_dict(state)
    rng = np.random.default_rng(seed + 1)
    w = rng.normal(0, clip_config.embed_dim ** -0.5,
                   (clip_config.embed_dim, train_config.num_classes)
                   ).astype(np.float32)
    model = Classifier(tower, torch.from_numpy(w),
                       torch.zeros(train_config.num_classes)).to(dev)
    return model, make_optimizer(train_config, model.parameters())


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at each optimizer count (steps taken before this
    one), as ``optax.warmup_cosine_decay_schedule(0, lr, warmup, T, lr/100)``
    or a constant."""
    if cfg.lr_schedule == "constant":
        return lambda count: cfg.learning_rate
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule!r}")
    if cfg.total_steps <= 0:
        raise ValueError("lr_schedule='cosine' needs total_steps > 0 "
                         "(the schedule must know its horizon)")
    peak = cfg.learning_rate
    warmup = min(max(cfg.total_steps // 10, 1), 100)
    decay = cfg.total_steps - warmup
    if decay <= 0:  # optax's cosine_decay_schedule refuses this too
        raise ValueError(f"lr_schedule='cosine' needs total_steps > the "
                         f"{warmup}-step warmup, got {cfg.total_steps}")
    alpha = 0.0 if peak == 0.0 else (peak / 100) / peak

    def schedule(count: int) -> float:
        if count < warmup:  # linear from 0 to the peak
            return -peak * (1 - count / warmup) + peak
        t = min(count - warmup, decay)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay))
        return peak * ((1 - alpha) * cosine + alpha)

    return schedule


class AdamW(torch.optim.AdamW):
    """``optax.adamw`` with a schedule: decoupled weight decay on every
    parameter, b1 0.9, b2 0.999, eps 1e-8, and the learning rate read at
    the count before the step (so a warmup's first step has lr 0). The
    count is the optimizer state's ``step``, so it survives
    ``state_dict``/``load_state_dict``."""

    def __init__(self, params: Iterable[torch.Tensor],
                 schedule: Callable[[int], float], weight_decay: float):
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=weight_decay)
        self.schedule = schedule

    @property
    def count(self) -> int:
        for state in self.state.values():
            if "step" in state:
                return int(state["step"])
        return 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.schedule(self.count)
        for group in self.param_groups:
            group["lr"] = lr
        return super().step(closure)


def make_optimizer(cfg: TrainConfig,
                   params: Iterable[torch.Tensor]) -> AdamW:
    return AdamW(params, make_schedule(cfg), cfg.weight_decay)


def loss_fn(model: Classifier, images: torch.Tensor, labels: torch.Tensor,
            cfg: TrainConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean NLL, accuracy) of the head over the tower's f32 embeddings."""
    emb = model.tower(images)
    w, b = model.head["w"], model.head["b"]
    if cfg.head == "cosine":
        def unit(x, dim):
            return x / torch.clamp_min(
                torch.linalg.vector_norm(x, dim=dim, keepdim=True), 1e-8)
        logits = cfg.cosine_scale * (unit(emb.float(), 1) @ unit(w, 0))
    else:
        logits = emb @ w + b
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return nll, acc


def make_train_step(cfg: TrainConfig):
    """One step on the model's device: (model, optimizer, images [B, H, W,
    3], int labels [B]) → metrics ``{"loss", "accuracy"}`` as detached 0-d
    tensors (the loss before the update), with the model updated in
    place."""

    def step(model: Classifier, optimizer: AdamW, images, labels
             ) -> dict[str, torch.Tensor]:
        dev = model.device
        x = torch.as_tensor(images, dtype=torch.float32, device=dev)
        y = torch.as_tensor(labels, device=dev).long()  # NLL wants int64
        optimizer.zero_grad(set_to_none=True)
        loss, acc = loss_fn(model, x, y, cfg)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "accuracy": acc.detach()}

    return step
