"""Seeded CLIP image-tower weights, made on the device.

One ``torch.Generator`` on the card draws every weight in one normal
call; the state dict is slices of that buffer, scaled as CLIP's
initialisation scales them, with small random biases and norm scales
around 1 so that every term of the block is exercised. Keys and layouts
are the tower's (``x @ w`` dense layers, the patch kernel HWIO, blocks as
``blocks.<i>.<name>``). The program and the reference are handed the same
dict.
"""

from __future__ import annotations

from benchcore.images import SEED_MASK


def shapes(cfg: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """name -> (shape, kind); kind is ``w`` (a product weight), ``b``
    (a bias), ``s`` (a norm scale) or ``e`` (an embedding)."""
    w, d_mlp = cfg["width"], cfg["mlp_ratio"] * cfg["width"]
    p, g = cfg["patch_size"], cfg["image_size"] // cfg["patch_size"]
    out = {
        "conv_kernel": ((p, p, 3, w), "w"),
        "class_embedding": ((w,), "e"),
        "positional_embedding": ((g * g + 1, w), "e"),
        "ln_pre_scale": ((w,), "s"), "ln_pre_bias": ((w,), "b"),
        "ln_post_scale": ((w,), "s"), "ln_post_bias": ((w,), "b"),
        "proj": ((w, cfg["embed_dim"]), "w"),
    }
    block = {
        "ln_1_scale": ((w,), "s"), "ln_1_bias": ((w,), "b"),
        "w_qkv": ((w, 3 * w), "w"), "b_qkv": ((3 * w,), "b"),
        "w_out": ((w, w), "w"), "b_out": ((w,), "b"),
        "ln_2_scale": ((w,), "s"), "ln_2_bias": ((w,), "b"),
        "w_fc": ((w, d_mlp), "w"), "b_fc": ((d_mlp,), "b"),
        "w_proj": ((d_mlp, w), "w"), "b_proj": ((w,), "b"),
    }
    for layer in range(cfg["layers"]):
        for k, v in block.items():
            out[f"blocks.{layer}.{k}"] = v
    return out


def clip_state(torch, cfg: dict, seed: int, device) -> dict:
    """f32 state dict on ``device`` from ``seed``."""
    specs = shapes(cfg)
    sizes = [_numel(s) for s, _ in specs.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    state, at = {}, 0
    for (name, (shape, kind)), n in zip(specs.items(), sizes):
        x = flat[at: at + n].view(shape)
        at += n
        if kind == "w":
            fan_in = _numel(shape[:-1])
            x = x * fan_in ** -0.5
        elif kind == "b":
            x = x * 0.02
        elif kind == "s":
            x = 1.0 + 0.1 * x
        else:
            x = x * cfg["width"] ** -0.5
        state[name] = x
    return state


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
