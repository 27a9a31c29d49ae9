"""SAM image encoder: ViT with windowed attention, decomposed relative
position embeddings and a conv neck — segment-anything's ImageEncoderViT,
as the JAX package's ``models/sam/encoder.py`` lays it out.

Parameters are the JAX package's pytree (``init_params`` draws the same
numbers; ``model.params_from_jax`` turns them into tensors): dense weights
``x @ w``, conv kernels HWIO, images NHWC. Every attention layer, windowed
(14 × 14 = 196 tokens at SAM-B) and global (64 × 64 = 4,096), runs
``ops.attention.flash_attention_2d_bias``: kernel B6 on a CUDA tensor, its
plain version on a CPU tensor. ``use_flash=False`` takes the JAX package's
einsum path instead (logits in f32, p rounded to the compute dtype), which
is the oracle the flash path is held against.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from retrieval_based_object_detection_tpu_torch.ops.attention import (
    flash_attention_2d_bias,
)
from retrieval_based_object_detection_tpu_torch.ops.dense import dense_f32

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: tuple[int, ...] = (2, 5, 8, 11)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.heads


def init_params(cfg: EncoderConfig, seed: int = 0) -> Params:
    """The JAX package's random init as a numpy pytree (the same numbers
    for the same seed); load it with ``model.params_from_jax``."""
    rng = np.random.default_rng(seed)
    d, g = cfg.embed_dim, cfg.grid

    def lin(cin, cout):
        return {"w": rng.normal(0, cin ** -0.5, (cin, cout)).astype(np.float32),
                "b": np.zeros(cout, np.float32)}

    def block(idx: int) -> Params:
        ws = 0 if idx in cfg.global_attn_indexes else cfg.window_size
        size = g if ws == 0 else ws
        return {
            "ln1_s": np.ones(d, np.float32), "ln1_b": np.zeros(d, np.float32),
            "qkv": lin(d, 3 * d),
            "proj": lin(d, d),
            "rel_h": rng.normal(0, 0.02, (2 * size - 1, cfg.head_dim)
                                ).astype(np.float32),
            "rel_w": rng.normal(0, 0.02, (2 * size - 1, cfg.head_dim)
                                ).astype(np.float32),
            "ln2_s": np.ones(d, np.float32), "ln2_b": np.zeros(d, np.float32),
            "fc1": lin(d, cfg.mlp_ratio * d),
            "fc2": lin(cfg.mlp_ratio * d, d),
        }

    return {
        "patch_kernel": rng.normal(
            0, (cfg.patch_size ** 2 * 3) ** -0.5,
            (cfg.patch_size, cfg.patch_size, 3, d)).astype(np.float32),
        "patch_bias": np.zeros(d, np.float32),
        "pos_embed": rng.normal(0, 0.02, (g, g, d)).astype(np.float32),
        "blocks": [block(i) for i in range(cfg.depth)],
        "neck0": rng.normal(0, d ** -0.5, (1, 1, d, cfg.out_chans)
                            ).astype(np.float32),
        "neck_ln0_s": np.ones(cfg.out_chans, np.float32),
        "neck_ln0_b": np.zeros(cfg.out_chans, np.float32),
        "neck1": rng.normal(0, (9 * cfg.out_chans) ** -0.5,
                            (3, 3, cfg.out_chans, cfg.out_chans)
                            ).astype(np.float32),
        "neck_ln1_s": np.ones(cfg.out_chans, np.float32),
        "neck_ln1_b": np.zeros(cfg.out_chans, np.float32),
    }


def _ln(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor,
        eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with f32 statistics (population
    variance, as ``jnp.var``), cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * s.float()
            + b.float()).to(x.dtype)


def _dense(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ w + b over the last axis, in x's dtype."""
    out = torch.addmm(p["b"], x.reshape(-1, x.shape[-1]), p["w"])
    return out.reshape(*x.shape[:-1], p["w"].shape[1])


def _rel_pos_bias(q_size: int, rel: torch.Tensor) -> torch.Tensor:
    """Decomposed relative position table lookup → [q, k, head_dim]:
    index (q - k + size - 1) into a (2·size - 1) table (segment-anything's
    get_rel_pos for equal q/k sizes)."""
    pos = torch.arange(q_size, device=rel.device)
    return rel[pos[:, None] - pos[None, :] + q_size - 1]


def _attention(x: torch.Tensor, blk: Params, heads: int,
               use_flash: bool = True) -> torch.Tensor:
    """[B, H, W, C] windowed or global attention with decomposed rel pos."""
    B, H, W, C = x.shape
    hd = C // heads
    T = H * W
    qkv = _dense(x.reshape(B, T, C), blk["qkv"])
    q, k, v = (t.reshape(B, T, heads, hd).transpose(1, 2).contiguous()
               for t in qkv.split(C, dim=-1))

    # Decomposed relative position (Rh over rows, Rw over cols):
    # bias[q, k2d] = q · Rh[qh, kh] + q · Rw[qw, kw].
    rh = _rel_pos_bias(H, blk["rel_h"]).float()  # [H, H, hd]
    rw = _rel_pos_bias(W, blk["rel_w"]).float()  # [W, W, hd]
    qg = q.reshape(B, heads, H, W, hd).float()
    bias_h = torch.einsum("bnhwd,hkd->bnhwk", qg, rh)  # [B, nh, H, W, Hk]
    bias_w = torch.einsum("bnhwd,wkd->bnhwk", qg, rw)  # [B, nh, H, W, Wk]

    if use_flash:
        out = flash_attention_2d_bias(
            q, k, v, bias_h.reshape(B, heads, T, H).contiguous(),
            bias_w.reshape(B, heads, T, W).contiguous(), grid_h=H, grid_w=W)
    else:
        attn = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        attn = (attn * hd ** -0.5).reshape(B, heads, H, W, H, W)
        attn = attn + bias_h[..., :, None] + bias_w[..., None, :]
        attn = torch.softmax(attn.reshape(B, heads, T, T), dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn.to(x.dtype).float(),
                           v.float()).to(x.dtype)

    out = out.transpose(1, 2).reshape(B, T, C)
    return _dense(out, blk["proj"]).reshape(B, H, W, C)


def _window_partition(x: torch.Tensor, ws: int):
    """Zero-pad [B, H, W, C] to multiples of ``ws`` and cut it into
    [B·nH·nW, ws, ws, C] windows (the padding takes part in attention, as
    in the JAX package and segment-anything)."""
    B, H, W, C = x.shape
    pad_h = (ws - H % ws) % ws
    pad_w = (ws - W % ws) % ws
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    wins = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)
    return wins, (Hp, Wp)


def _window_unpartition(wins: torch.Tensor, ws: int, hw_pad, hw):
    Hp, Wp = hw_pad
    H, W = hw
    B = wins.shape[0] // ((Hp // ws) * (Wp // ws))
    x = wins.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def _block_forward(x: torch.Tensor, blk: Params, heads: int, window: int,
                   use_flash: bool = True) -> torch.Tensor:
    h = _ln(x, blk["ln1_s"], blk["ln1_b"])
    if window > 0:
        wins, hw_pad = _window_partition(h, window)
        wins = _attention(wins, blk, heads, use_flash=use_flash)
        h = _window_unpartition(wins, window, hw_pad, x.shape[1:3])
    else:
        h = _attention(h, blk, heads, use_flash=use_flash)
    x = x + h
    h = _ln(x, blk["ln2_s"], blk["ln2_b"])
    # The GELU takes the f32 sum, as in the JAX block.
    h = F.gelu(dense_f32(h, blk["fc1"]["w"], blk["fc1"]["b"]),
               approximate="none")
    return x + _dense(h.to(x.dtype), blk["fc2"])


def _cast(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def forward(params: Params, images: torch.Tensor, cfg: EncoderConfig,
            compute_dtype: torch.dtype = torch.float32,
            use_flash: bool | None = None) -> torch.Tensor:
    """[B, S, S, 3] (already normalised) → [B, grid, grid, out_chans] in
    ``compute_dtype``. ``use_flash`` None or True routes every attention
    layer through the flash wrapper (B6 on the card); False takes the
    einsum path."""
    use_flash = True if use_flash is None else use_flash
    cd = compute_dtype
    x = images.to(cd)
    B, p, g = x.shape[0], cfg.patch_size, cfg.grid
    # Patch embedding: the stride-p VALID conv (NHWC/HWIO) as one matmul
    # over [p, p, 3]-ordered patches.
    x = x[:, : g * p, : g * p].reshape(B, g, p, g, p, 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, g, g, p * p * 3)
    x = x @ params["patch_kernel"].to(cd).reshape(p * p * 3, -1)
    x = x + params["patch_bias"].to(cd)
    x = x + params["pos_embed"].to(cd)[None]

    for i, blk in enumerate(params["blocks"]):
        window = 0 if i in cfg.global_attn_indexes else cfg.window_size
        x = _block_forward(x, _cast(blk, cd), cfg.heads, window,
                           use_flash=use_flash)

    # Neck: 1x1 conv + LN + 3x3 SAME conv + LN (channel-last LN over C).
    x = x @ params["neck0"].to(cd)[0, 0]
    x = _ln(x, params["neck_ln0_s"], params["neck_ln0_b"])
    w1 = params["neck1"].to(cd).permute(3, 2, 0, 1)  # HWIO → OIHW
    x = F.conv2d(x.permute(0, 3, 1, 2), w1, padding=1).permute(0, 2, 3, 1)
    return _ln(x, params["neck_ln1_s"], params["neck_ln1_b"])
