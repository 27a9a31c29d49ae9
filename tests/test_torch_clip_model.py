"""Port parity: the CLIP vision tower against the JAX package.

Weights are the JAX ``init_params`` pytree carried across by
``params_from_jax``; images are the same numpy-seeded NHWC arrays. The JAX
tower runs its einsum attention path; the port's CPU path runs the plain
attention core (the kernel's reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.models.clip import model as jm
from retrieval_based_object_detection_tpu_torch.models.clip import model as tm

TINY = dict(image_size=64, patch_size=16, width=64, layers=2, heads=1,
            embed_dim=32)
# heads > 1 so the head split and merge of the attention core are exercised.
MULTI = dict(image_size=64, patch_size=16, width=64, layers=2, heads=4,
             embed_dim=32)


def _numpy_params(jparams):
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in jparams.items()}


@pytest.mark.parametrize("cfg", [TINY, MULTI], ids=["tiny", "heads4"])
def test_encode_image_f32_matches_jax(cfg):
    """f32 to 2e-4, the tolerance of tests/test_clip_fused_attention.py."""
    jcfg = jm.CLIPVisionConfig(**cfg)
    jparams = jm.init_params(jcfg, seed=3)
    images = np.random.default_rng(1).normal(
        size=(3, cfg["image_size"], cfg["image_size"], 3)).astype(np.float32)
    want = np.asarray(jm.encode_image(jparams, jnp.asarray(images), jcfg,
                                      fused_attention=False))
    tower = tm.build_tower(tm.params_from_jax(_numpy_params(jparams)),
                           tm.CLIPVisionConfig(**cfg), device="cpu")
    got = tm.encode_image(tower, torch.from_numpy(images)).numpy()
    assert got.shape == (3, cfg["embed_dim"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_init_params_is_the_jax_init():
    """The port's numpy init draws the same numbers as the JAX package's
    for the same seed, so a seeded run is the same model in both."""
    jcfg = jm.CLIPVisionConfig(**MULTI)
    jp = _numpy_params(jm.init_params(jcfg, seed=7))
    tp = tm.init_params(tm.CLIPVisionConfig(**MULTI), seed=7)
    assert jp.keys() == tp.keys()
    for k in jp:
        if k == "blocks":
            for kk in jp[k]:
                np.testing.assert_array_equal(tp[k][kk], jp[k][kk])
        else:
            np.testing.assert_array_equal(tp[k], jp[k])


def test_bf16_tower_stays_close_to_f32():
    """bf16 compute (the serving dtype): cosine to the f32 embedding above
    0.999 on the tiny tower."""
    cfg = tm.CLIPVisionConfig(**MULTI)
    params = tm.init_params(cfg, seed=2)
    images = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 64, 64, 3)).astype(np.float32))
    f32 = tm.encode_image(tm.build_tower(params, cfg, device="cpu"), images)
    bf16 = tm.encode_image(tm.build_tower(params, cfg, dtype=torch.bfloat16,
                                          device="cpu"), images)
    assert bf16.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(f32, bf16, dim=1)
    assert (cos > 0.999).all(), cos


def test_layer_norm_and_quick_gelu_match_jax():
    x = np.random.default_rng(0).normal(size=(5, 64)).astype(np.float32) * 3
    s = np.random.default_rng(1).normal(size=64).astype(np.float32)
    b = np.random.default_rng(2).normal(size=64).astype(np.float32)
    want = np.asarray(jm.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                    jnp.asarray(b)))
    got = tm.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                        torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        tm.quick_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jm.quick_gelu(jnp.asarray(x))), atol=1e-6)


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.build_tower(tm.init_params(tm.CLIPVisionConfig(**TINY)),
                       tm.CLIPVisionConfig(**TINY))


def _non_unit_ln_params(jcfg, seed):
    """Seeded JAX params with LayerNorm scales and biases away from 1 and
    0, as after fine-tuning."""
    p = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
             if isinstance(v, dict) else np.asarray(v))
         for k, v in jm.init_params(jcfg, seed=seed).items()}
    rng = np.random.default_rng(seed + 100)
    for tree, keys in ((p, ("ln_pre", "ln_post")),
                       (p["blocks"], ("ln_1", "ln_2"))):
        for k in keys:
            shape = tree[k + "_scale"].shape
            tree[k + "_scale"] = (1 + 0.5 * rng.normal(size=shape)
                                  ).astype(np.float32)
            tree[k + "_bias"] = (0.2 * rng.normal(size=shape)
                                 ).astype(np.float32)
    return p


@pytest.mark.parametrize("layers,rel_tol", [(0, 1e-6), (2, 1e-2)])
def test_bf16_encode_tracks_jax_bf16(layers, rel_tol):
    """The bf16 tower casts where JAX's ``encode_image`` casts: f32
    ``ln_pre``/``ln_post`` scale and bias, everything else in bf16 at use.
    With no blocks the two agree to 1e-6 of the largest |embedding| (f32
    parameters rounded to bf16, as before this casting, miss by ~6e-3).
    With blocks, 1e-2: torch's bf16 ``addmm`` rounds the MLP's fc output to
    bf16 before the GELU where JAX applies the GELU to the f32 sum, one
    bf16 rounding (2^-9) per block feeding the residual stream."""
    cfg = dict(MULTI, layers=layers)
    jcfg = jm.CLIPVisionConfig(**cfg)
    p = _non_unit_ln_params(jcfg, seed=3)
    images = np.random.default_rng(4).normal(
        size=(4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.encode_image(
        jax.tree.map(jnp.asarray, p), jnp.asarray(images), jcfg,
        jnp.bfloat16, fused_attention=False))
    tower = tm.build_tower(p, tm.CLIPVisionConfig(**cfg),
                           dtype=torch.bfloat16, device="cpu")
    assert all(v.dtype == torch.float32 for v in tower.parameters())
    got = tm.encode_image(tower, torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel_tol * np.abs(want).max())


def test_build_tower_is_frozen_and_the_training_tower_is_not():
    cfg = tm.CLIPVisionConfig(**TINY)
    frozen = tm.build_tower(tm.init_params(cfg), cfg, device="cpu")
    assert not any(p.requires_grad for p in frozen.parameters())
    assert all(p.requires_grad
               for p in tm.CLIPVisionTower(cfg).parameters())
