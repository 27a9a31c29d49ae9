"""CLIP vision transformer in PyTorch.

Functionally the OpenAI CLIP visual tower the reference loads at
31_clip_embedding_and_save_vector.py:26 (``clip.load("ViT-B/32")``):
patchify → [CLS] + positional embeddings → pre-LN transformer with QuickGELU
MLPs → ln_post on the CLS token → projection to the embedding dimension.

Weights keep the JAX package's layout (``x @ w`` for every dense layer, the
patch kernel HWIO), so ``params_from_jax`` carries a JAX ``init_params``
pytree across by slicing its stacked ``[L, ...]`` blocks. Images are NHWC,
as in the JAX package. Parameters stay f32; the tower computes in its
``compute_dtype`` (f32, or bf16) and casts where the JAX package's
``encode_image`` casts: the images, patch kernel, class and positional
embeddings, every block parameter and ``proj`` go to the compute dtype at
use, while ``ln_pre``/``ln_post`` keep their f32 scale and bias. LayerNorm
statistics, the attention softmax and the final projection's sums are f32
either way. Gradients reach the f32 parameters through those casts, so one
tower serves inference and bf16 training on f32 master weights; with
``remat`` each block is recomputed in the backward
(``torch.utils.checkpoint``).

The attention core runs ``ops.clip_attention.clip_attention_core``: the
hand-written forward (and, under autograd, backward) for every CUDA tensor
(f32 and bf16), the plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from retrieval_based_object_detection_tpu_torch.ops.clip_attention import (
    clip_attention_core,
)
from retrieval_based_object_detection_tpu_torch.ops.dense import dense_f32
from retrieval_based_object_detection_tpu_torch.utils.platform import (
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768          # transformer hidden size
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512      # output projection dim
    mlp_ratio: int = 4

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # patches + CLS

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


VIT_B_32 = CLIPVisionConfig()

_BLOCK_KEYS = ("ln_1_scale", "ln_1_bias", "w_qkv", "b_qkv", "w_out", "b_out",
               "ln_2_scale", "ln_2_bias", "w_fc", "b_fc", "w_proj", "b_proj")
_TOP_KEYS = ("conv_kernel", "class_embedding", "positional_embedding",
             "ln_pre_scale", "ln_pre_bias", "ln_post_scale", "ln_post_bias",
             "proj")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702x) — CLIP's activation (not tanh-GELU)."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics regardless of compute dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b with the bias added inside the product's epilogue."""
    out = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[1])


def init_params(config: CLIPVisionConfig = VIT_B_32,
                seed: int = 0) -> dict[str, Any]:
    """Random init matching torch defaults in scale, as a numpy pytree in
    the JAX package's layout (the same numbers as its ``init_params`` for
    the same seed); load it with ``params_from_jax``."""
    rng = np.random.default_rng(seed)
    w, L = config.width, config.layers
    d_mlp = config.mlp_ratio * w
    scale = w ** -0.5

    def normal(shape, std):
        return rng.normal(0.0, std, size=shape).astype(np.float32)

    blocks = {
        "ln_1_scale": np.ones((L, w), np.float32),
        "ln_1_bias": np.zeros((L, w), np.float32),
        "w_qkv": normal((L, w, 3 * w), scale),
        "b_qkv": np.zeros((L, 3 * w), np.float32),
        "w_out": normal((L, w, w), scale),
        "b_out": np.zeros((L, w), np.float32),
        "ln_2_scale": np.ones((L, w), np.float32),
        "ln_2_bias": np.zeros((L, w), np.float32),
        "w_fc": normal((L, w, d_mlp), scale),
        "b_fc": np.zeros((L, d_mlp), np.float32),
        "w_proj": normal((L, d_mlp, w), (2 * w) ** -0.5),
        "b_proj": np.zeros((L, w), np.float32),
    }
    return {
        "conv_kernel": normal(
            (config.patch_size, config.patch_size, 3, w), scale),  # HWIO
        "class_embedding": normal((w,), scale),
        "positional_embedding": normal((config.seq_len, w), 0.01),
        "ln_pre_scale": np.ones((w,), np.float32),
        "ln_pre_bias": np.zeros((w,), np.float32),
        "blocks": blocks,
        "ln_post_scale": np.ones((w,), np.float32),
        "ln_post_bias": np.zeros((w,), np.float32),
        "proj": normal((w, config.embed_dim), scale),
    }


def params_from_jax(numpy_params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A JAX ``init_params`` pytree (numpy arrays, stacked ``[L, ...]``
    blocks, HWIO patch kernel) → a state dict for ``CLIPVisionTower``."""
    state = {k: torch.tensor(np.asarray(numpy_params[k], np.float32))
             for k in _TOP_KEYS}
    blocks = numpy_params["blocks"]
    for layer in range(np.asarray(blocks["w_qkv"]).shape[0]):
        for k in _BLOCK_KEYS:
            state[f"blocks.{layer}.{k}"] = torch.tensor(
                np.asarray(blocks[k][layer], np.float32))
    return state


class ResidualAttentionBlock(nn.Module):
    """Pre-LN residual attention block with a QuickGELU MLP."""

    def __init__(self, width: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.heads = heads
        d_mlp = mlp_ratio * width
        shapes = {
            "ln_1_scale": (width,), "ln_1_bias": (width,),
            "w_qkv": (width, 3 * width), "b_qkv": (3 * width,),
            "w_out": (width, width), "b_out": (width,),
            "ln_2_scale": (width,), "ln_2_bias": (width,),
            "w_fc": (width, d_mlp), "b_fc": (d_mlp,),
            "w_proj": (d_mlp, width), "b_proj": (width,),
        }
        for k, shape in shapes.items():
            setattr(self, k, nn.Parameter(torch.zeros(shape)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """One block in ``x``'s dtype: every parameter is cast to it at
        use, as the JAX tower casts its stacked blocks."""
        p = {k: v.to(x.dtype) for k, v in self.named_parameters()}
        h = layer_norm(x, p["ln_1_scale"], p["ln_1_bias"])
        qkv = _dense(h, p["w_qkv"], p["b_qkv"])            # [B, T, 3W]
        a = clip_attention_core(qkv, heads=self.heads)      # [B, T, W]
        x = x + _dense(a, p["w_out"], p["b_out"])
        h = layer_norm(x, p["ln_2_scale"], p["ln_2_bias"])
        # The GELU takes the f32 sum, as in the JAX block.
        h = quick_gelu(dense_f32(h, p["w_fc"], p["b_fc"])).to(x.dtype)
        return x + _dense(h, p["w_proj"], p["b_proj"])


class CLIPVisionTower(nn.Module):
    """The image tower: NHWC images → [B, embed_dim] f32 embeddings
    (un-normalised, matching ``model.encode_image`` of the reference),
    computed in ``compute_dtype`` from f32 parameters."""

    def __init__(self, config: CLIPVisionConfig = VIT_B_32,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.config = config
        self.compute_dtype = compute_dtype
        self.remat = remat
        c = config
        shapes = {
            "conv_kernel": (c.patch_size, c.patch_size, 3, c.width),
            "class_embedding": (c.width,),
            "positional_embedding": (c.seq_len, c.width),
            "ln_pre_scale": (c.width,), "ln_pre_bias": (c.width,),
            "ln_post_scale": (c.width,), "ln_post_bias": (c.width,),
            "proj": (c.width, c.embed_dim),
        }
        for k, shape in shapes.items():
            setattr(self, k, nn.Parameter(torch.zeros(shape)))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(c.width, c.heads, c.mlp_ratio)
            for _ in range(c.layers))

    @property
    def device(self) -> torch.device:
        return self.proj.device

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.config
        cd = self.compute_dtype
        x = images.to(device=self.device, dtype=cd)
        B = x.shape[0]
        p, g = c.patch_size, c.grid
        # Patchify: the stride-p VALID conv (NHWC/HWIO) as one matmul over
        # [p, p, 3]-ordered patches — the same product, and no cuDNN.
        x = x[:, : g * p, : g * p]
        x = x.reshape(B, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, g * g, p * p * 3) @ self.conv_kernel.to(cd).reshape(
            p * p * 3, c.width)
        cls = self.class_embedding.to(cd).expand(B, 1, c.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(cd)[None]
        x = layer_norm(x, self.ln_pre_scale, self.ln_pre_bias)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = (torch.utils.checkpoint.checkpoint(block, x,
                                                   use_reentrant=False)
                 if remat else block(x))
        cls_out = layer_norm(x[:, 0, :], self.ln_post_scale,
                             self.ln_post_bias)
        # Products of values in the compute dtype are exact in f32: this is
        # the f32-accumulated projection of the JAX tower.
        return cls_out.to(torch.float32) @ self.proj.to(cd).to(torch.float32)


def build_tower(params: dict[str, Any], config: CLIPVisionConfig = VIT_B_32,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda") -> CLIPVisionTower:
    """A frozen tower on ``device`` computing in ``dtype``, its f32
    parameters from a state dict (as ``params_from_jax`` returns) or a
    JAX-layout numpy pytree."""
    if "blocks" in params:
        params = params_from_jax(params)
    tower = CLIPVisionTower(config, compute_dtype=dtype)
    tower.load_state_dict(params)
    tower.requires_grad_(False)
    return tower.to(device=resolve_device(device)).eval()


@torch.inference_mode()
def encode_image(tower: CLIPVisionTower, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] preprocessed NHWC images → [B, embed_dim] f32
    embeddings, computed in the tower's compute dtype on its device."""
    return tower(images)
