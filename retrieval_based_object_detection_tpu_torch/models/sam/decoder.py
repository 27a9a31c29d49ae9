"""SAM prompt encoder + two-way transformer mask decoder.

segment-anything's PromptEncoder/MaskDecoder structure as the JAX
package's ``models/sam/decoder.py`` lays it out: random Fourier positional
encoding for points, learned point-type embeddings, two-way attention
blocks with a downsampled internal dim, the IoU head, per-mask
hypernetwork MLPs and 4× transposed-conv upscaling. Its attentions are
plain matmuls (a handful of prompt tokens against the image grid), as in
the JAX package, which runs them outside any Pallas kernel.

``jax.lax.conv_transpose`` does not flip its kernel (``transpose_kernel``
is False), where ``torch.nn.functional.conv_transpose2d`` would: the two
stride-2 2×2 "SAME" upscales here are written out as the product JAX
computes, ``out[2i + a, 2j + c] = x[i, j] · w[1 − a, 1 − c]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from retrieval_based_object_detection_tpu_torch.models.sam.encoder import _ln

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    embed_dim: int = 256          # prompt/mask transformer dim
    depth: int = 2                # two-way blocks
    heads: int = 8
    mlp_dim: int = 2048
    downsample_rate: int = 2      # internal attention dim = embed/rate
    num_multimask: int = 3        # 3 multimask outputs (+1 single)
    iou_head_hidden: int = 256
    iou_head_depth: int = 3

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask + 1


def init_params(cfg: DecoderConfig, seed: int = 0) -> Params:
    """The JAX package's random init as a numpy pytree (the same numbers
    for the same seed)."""
    rng = np.random.default_rng(seed)
    d = cfg.embed_dim

    def lin(cin, cout):
        return {"w": rng.normal(0, cin ** -0.5, (cin, cout)).astype(np.float32),
                "b": np.zeros(cout, np.float32)}

    def attn(dim, inner):
        return {"q": lin(dim, inner), "k": lin(dim, inner),
                "v": lin(dim, inner), "out": lin(inner, dim)}

    inner = d // cfg.downsample_rate

    def twoway_block():
        return {
            "self_attn": attn(d, d),
            "ln1_s": np.ones(d, np.float32), "ln1_b": np.zeros(d, np.float32),
            "cross_t2i": attn(d, inner),
            "ln2_s": np.ones(d, np.float32), "ln2_b": np.zeros(d, np.float32),
            "fc1": lin(d, cfg.mlp_dim), "fc2": lin(cfg.mlp_dim, d),
            "ln3_s": np.ones(d, np.float32), "ln3_b": np.zeros(d, np.float32),
            "cross_i2t": attn(d, inner),
            "ln4_s": np.ones(d, np.float32), "ln4_b": np.zeros(d, np.float32),
        }

    def mlp(cin, hidden, cout, depth):
        dims = [cin] + [hidden] * (depth - 1) + [cout]
        return [lin(dims[i], dims[i + 1]) for i in range(depth)]

    return {
        # Prompt encoder.
        "pe_gaussian": rng.normal(0, 1.0, (2, d // 2)).astype(np.float32),
        "point_embed_neg": rng.normal(0, 0.02, (d,)).astype(np.float32),
        "point_embed_pos": rng.normal(0, 0.02, (d,)).astype(np.float32),
        "not_a_point": rng.normal(0, 0.02, (d,)).astype(np.float32),
        "no_mask_embed": rng.normal(0, 0.02, (d,)).astype(np.float32),
        # Decoder tokens.
        "iou_token": rng.normal(0, 0.02, (d,)).astype(np.float32),
        "mask_tokens": rng.normal(0, 0.02, (cfg.num_mask_tokens, d)
                                  ).astype(np.float32),
        "blocks": [twoway_block() for _ in range(cfg.depth)],
        "final_t2i": attn(d, inner),
        "final_ln_s": np.ones(d, np.float32),
        "final_ln_b": np.zeros(d, np.float32),
        # Upscaling: two stride-2 transposed convs d -> d/4 -> d/8.
        "up0": rng.normal(0, d ** -0.5, (2, 2, d, d // 4)).astype(np.float32),
        "up_ln_s": np.ones(d // 4, np.float32),
        "up_ln_b": np.zeros(d // 4, np.float32),
        "up1": rng.normal(0, (d // 4) ** -0.5, (2, 2, d // 4, d // 8)
                          ).astype(np.float32),
        "hyper_mlps": [mlp(d, d, d // 8, 3)
                       for _ in range(cfg.num_mask_tokens)],
        "iou_mlp": mlp(d, cfg.iou_head_hidden, cfg.num_mask_tokens,
                       cfg.iou_head_depth),
    }


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return (x @ p["w"] + p["b"]).to(x.dtype)


def _mha(q, k, v, p: Params, heads: int) -> torch.Tensor:
    """Multi-head attention with per-projection params ([B, T, D] each)."""
    B, Tq, _ = q.shape
    qh, kh, vh = _linear(q, p["q"]), _linear(k, p["k"]), _linear(v, p["v"])
    inner = qh.shape[-1]
    hd = inner // heads

    def split(t):
        return t.reshape(B, -1, heads, hd).transpose(1, 2)

    qh, kh, vh = split(qh), split(kh), split(vh)
    attn = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) \
        * hd ** -0.5
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", attn.float(),
                       vh.float()).to(q.dtype)
    out = out.transpose(1, 2).reshape(B, Tq, inner)
    return _linear(out, p["out"])


def point_pe(coords: torch.Tensor, gaussian: torch.Tensor) -> torch.Tensor:
    """Random-Fourier positional encoding of [..., 2] coords in [0, 1]."""
    x = coords * 2.0 - 1.0
    proj = 2 * np.pi * torch.matmul(x, gaussian)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def grid_pe(g: int, gaussian: torch.Tensor) -> torch.Tensor:
    """[g, g, D] positional encoding of the image-embedding grid."""
    ramp = (torch.arange(g, dtype=torch.float32, device=gaussian.device)
            + 0.5) / g
    grid = torch.stack(torch.meshgrid(ramp, ramp, indexing="xy"), dim=-1)
    return point_pe(grid, gaussian)


def encode_points(params: Params, points: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """points [B, P, 2] in [0,1], labels [B, P] (1 pos, 0 neg, -1 pad)
    → sparse prompt tokens [B, P, D]."""
    pe = point_pe(points, params["pe_gaussian"])
    lab = labels[..., None]
    return torch.where(lab == 1, pe + params["point_embed_pos"],
                       torch.where(lab == 0, pe + params["point_embed_neg"],
                                   params["not_a_point"]))


def conv_transpose_2x2(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jax.lax.conv_transpose(x, w, (2, 2), "SAME")`` for NHWC ``x`` and a
    2×2 HWIO ``w``: out[b, 2i + a, 2j + c] = x[b, i, j] · w[1 − a, 1 − c]
    (JAX does not flip the kernel)."""
    B, H, W, _ = x.shape
    y = torch.einsum("bijc,hwco->bihjwo", x, w.flip(0, 1))
    return y.reshape(B, 2 * H, 2 * W, w.shape[-1])


def decode_masks(
    params: Params,
    image_embedding: torch.Tensor,  # [B, g, g, D]
    points: torch.Tensor,           # [B, P, 2] normalised to [0, 1]
    labels: torch.Tensor,           # [B, P]
    cfg: DecoderConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (mask_logits [B, num_mask_tokens, 4g, 4g], iou_pred [B, tokens])."""
    B, g, _, d = image_embedding.shape
    sparse = encode_points(params, points, labels)
    tokens = torch.cat([
        params["iou_token"].expand(B, 1, d),
        params["mask_tokens"].expand(B, cfg.num_mask_tokens, d),
        sparse.to(params["iou_token"].dtype),
    ], dim=1)

    src = image_embedding.reshape(B, g * g, d)
    src = src + params["no_mask_embed"]  # dense prompt = none
    img_pe = grid_pe(g, params["pe_gaussian"]).reshape(1, g * g, d)
    tok_pe = tokens  # token PEs are the tokens themselves at entry

    q = tokens
    for bi, blk in enumerate(params["blocks"]):
        # Token self-attention. The first block skips the token PE and the
        # residual (segment-anything's skip_first_layer_pe).
        if bi == 0:
            q = _ln(_mha(q, q, q, blk["self_attn"], cfg.heads),
                    blk["ln1_s"], blk["ln1_b"], eps=1e-5)
        else:
            q = _ln(q + _mha(q + tok_pe, q + tok_pe, q, blk["self_attn"],
                             cfg.heads), blk["ln1_s"], blk["ln1_b"],
                    eps=1e-5)
        # Tokens attend to image.
        q = _ln(q + _mha(q + tok_pe, src + img_pe, src, blk["cross_t2i"],
                         cfg.heads), blk["ln2_s"], blk["ln2_b"], eps=1e-5)
        # MLP.
        h = torch.relu(_linear(q, blk["fc1"]))
        q = _ln(q + _linear(h, blk["fc2"]), blk["ln3_s"], blk["ln3_b"],
                eps=1e-5)
        # Image attends to tokens.
        src = _ln(src + _mha(src + img_pe, q + tok_pe, q, blk["cross_i2t"],
                             cfg.heads), blk["ln4_s"], blk["ln4_b"],
                  eps=1e-5)

    q = q + _mha(q + tok_pe, src + img_pe, src, params["final_t2i"],
                 cfg.heads)
    q = _ln(q, params["final_ln_s"], params["final_ln_b"], eps=1e-5)

    iou_tok = q[:, 0]
    mask_toks = q[:, 1:1 + cfg.num_mask_tokens]

    # Upscale image features 4x.
    feat = conv_transpose_2x2(src.reshape(B, g, g, d), params["up0"])
    feat = F.gelu(_ln(feat, params["up_ln_s"], params["up_ln_b"]),
                  approximate="none")
    feat = F.gelu(conv_transpose_2x2(feat, params["up1"]),
                  approximate="none")  # [B, 4g, 4g, d/8]

    # Hypernetwork per mask token → dot with upscaled features.
    outs = []
    for i, mlp_params in enumerate(params["hyper_mlps"]):
        h = mask_toks[:, i]
        for j, lin_p in enumerate(mlp_params):
            h = _linear(h, lin_p)
            if j < len(mlp_params) - 1:
                h = torch.relu(h)
        outs.append(torch.einsum("bhwc,bc->bhw", feat.float(), h.float()))
    masks = torch.stack(outs, dim=1)  # [B, tokens, 4g, 4g]

    h = iou_tok
    for j, lin_p in enumerate(params["iou_mlp"]):
        h = _linear(h, lin_p)
        if j < len(params["iou_mlp"]) - 1:
            h = torch.relu(h)
    return masks, h
