"""The CLIP image tower (OpenAI CLIP's ``VisionTransformer``), in plain
PyTorch, f32, from the benchmark's state dict.

patchify (the stride-p conv as one product over [p, p, 3]-ordered
patches) → [CLS] + positional embeddings → ln_pre → pre-LN blocks
(LayerNorm ε 1e-5, packed qkv, softmax attention with scale hd^-½,
output projection, QuickGELU MLP) → ln_post on [CLS] → projection.

Every product goes through ``mm``: by default an f32 product with TF32
off (``exact_f32``); the control passes a product in a lower precision.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """TF32 off for f32 products, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _ln(x, scale, bias, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def encode(state: dict, cfg: dict, images: torch.Tensor, mm=f32_mm
           ) -> torch.Tensor:
    """[B, S, S, 3] normalised NHWC images → [B, embed_dim] f32
    embeddings (un-normalised), on ``images``' device."""
    dev = images.device
    p_ = {k: v.to(device=dev, dtype=torch.float32) for k, v in state.items()}
    w, heads = cfg["width"], cfg["heads"]
    p, g = cfg["patch_size"], cfg["image_size"] // cfg["patch_size"]
    hd = w // heads
    x = images.to(torch.float32)[:, : g * p, : g * p]
    b = x.shape[0]
    x = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = mm(x.reshape(b, g * g, p * p * 3),
           p_["conv_kernel"].reshape(p * p * 3, w))
    cls = p_["class_embedding"].expand(b, 1, w)
    x = torch.cat([cls, x], dim=1) + p_["positional_embedding"][None]
    x = _ln(x, p_["ln_pre_scale"], p_["ln_pre_bias"])
    t = x.shape[1]
    for layer in range(cfg["layers"]):
        k = f"blocks.{layer}."
        h = _ln(x, p_[k + "ln_1_scale"], p_[k + "ln_1_bias"])
        qkv = mm(h, p_[k + "w_qkv"]) + p_[k + "b_qkv"]
        q, kk, v = (z.reshape(b, t, heads, hd).transpose(1, 2)
                    for z in qkv.split(w, dim=-1))
        att = torch.softmax(mm(q, kk.transpose(-1, -2)) * hd ** -0.5,
                            dim=-1)
        a = mm(att, v).transpose(1, 2).reshape(b, t, w)
        x = x + mm(a, p_[k + "w_out"]) + p_[k + "b_out"]
        h = _ln(x, p_[k + "ln_2_scale"], p_[k + "ln_2_bias"])
        h = mm(h, p_[k + "w_fc"]) + p_[k + "b_fc"]
        h = h * torch.sigmoid(1.702 * h)
        x = x + mm(h, p_[k + "w_proj"]) + p_[k + "b_proj"]
    cls_out = _ln(x[:, 0, :], p_["ln_post_scale"], p_["ln_post_bias"])
    return mm(cls_out, p_["proj"])


def encode_blocks(state: dict, cfg: dict, images: torch.Tensor,
                  block: int = 64, mm=f32_mm) -> torch.Tensor:
    """``encode`` in blocks of ``block`` images, so that it fits beside
    whatever the process still holds."""
    with torch.no_grad(), exact_f32():
        return torch.cat([encode(state, cfg, images[i: i + block], mm)
                          for i in range(0, images.shape[0], block)])


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product: both operands rounded to float8 e4m3 with
    one scale a tensor (amax to 448), multiplied in f32. The step below
    bf16."""
    return torch.matmul(_fp8(a), _fp8(b))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax(), min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control's product for f32: TF32 on, the step below f32 with
    TF32 off (on the CPU, operands rounded to TF32's 10-bit mantissa)."""
    if a.device.type == "cuda":
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    return torch.matmul(_tf32(a), _tf32(b))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)
