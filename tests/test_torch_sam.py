"""Port parity: SAM's encoder, decoder, predictor and the segment stage
against the JAX package.

Weights are the JAX ``init_params`` pytree carried across by
``params_from_jax``; images are the same numpy-seeded arrays. The JAX
encoder runs its einsum attention (the CPU default); the port's encoder
runs the flash wrapper's plain version (kernel B6's reference) and, for
the oracle, its own einsum path. Tolerances are the JAX package's own:
1e-4 for the encoder (tests/test_flash_2d_bias.py), iou 1e-5 and mask
agreement above 0.999 for the predictor (tests/test_sam.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from retrieval_based_object_detection_tpu.models.sam import decoder as JD
from retrieval_based_object_detection_tpu.models.sam import encoder as JE
from retrieval_based_object_detection_tpu.models.sam import model as JM
from retrieval_based_object_detection_tpu.pipelines import segment as jseg
from retrieval_based_object_detection_tpu_torch.models.sam import decoder as D
from retrieval_based_object_detection_tpu_torch.models.sam import encoder as E
from retrieval_based_object_detection_tpu_torch.models.sam import model as M
from retrieval_based_object_detection_tpu_torch.pipelines import segment as seg

# The grid-16 encoder of tests/test_flash_2d_bias.py: one global layer of
# T = 256 and windowed layers of 4 × 4.
GRID16 = dict(img_size=64, patch_size=4, embed_dim=32, depth=2, heads=2,
              out_chans=16, window_size=4, global_attn_indexes=(1,))
# A grid that the window does not divide: 10 × 10 with windows of 4, so the
# zero padding takes part in the windowed attention.
PADDED = dict(img_size=40, patch_size=4, embed_dim=32, depth=2, heads=2,
              out_chans=16, window_size=4, global_attn_indexes=(1,))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    return JM.init_params(JM.SAM_TINY, seed=0)


@pytest.fixture(scope="module")
def predictors(jax_params):
    port = M.SamPredictor(M.params_from_jax(_numpy(jax_params)), M.SAM_TINY,
                          device="cpu")
    return JM.SamPredictor(jax_params, JM.SAM_TINY), port


def test_init_params_is_the_jax_init():
    want = _numpy(JM.init_params(JM.SAM_TINY, seed=3))
    got = M.init_params(M.SAM_TINY, seed=3)
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(got)
    assert tree_w == tree_g
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg", [None, GRID16, PADDED],
                         ids=["tiny", "grid16", "padded"])
@pytest.mark.parametrize("use_flash", [None, False], ids=["flash", "einsum"])
def test_encoder_matches_jax(cfg, use_flash):
    jcfg = JM.SAM_TINY.encoder if cfg is None else JE.EncoderConfig(**cfg)
    tcfg = M.SAM_TINY.encoder if cfg is None else E.EncoderConfig(**cfg)
    params = E.init_params(tcfg, seed=1)
    x = np.random.default_rng(2).normal(
        size=(2, tcfg.img_size, tcfg.img_size, 3)).astype(np.float32)
    want = np.asarray(JE.forward(jax.tree.map(jnp.asarray, params), x, jcfg,
                                 use_flash=False))
    got = E.forward(M.params_from_jax(params), torch.from_numpy(x), tcfg,
                    use_flash=use_flash).numpy()
    assert got.shape == (2, tcfg.grid, tcfg.grid, tcfg.out_chans)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_encoder_bf16_matches_jax_bf16():
    """SAM_TINY's encoder in bf16, einsum attention on both sides. Each
    block on the same bf16 input agrees with JAX's to within one bf16 ulp
    of its largest output, with under 1% of outputs apart (sums in another
    order; the MLP's GELU takes the f32 sum of ``fc1`` on both sides —
    rounded first, ~40% of a block's outputs differ). The whole encoder:
    within 4e-2 of outputs up to ~3.3 (2^-5, two bf16 ulps there; 2.3e-2
    measured), since those one-ulp flips spread through the neck's convs
    and LayerNorms."""
    cfg = M.SAM_TINY.encoder
    params = E.init_params(cfg, seed=1)
    tparams = M.params_from_jax(params)
    x = np.random.default_rng(3).normal(
        size=(2, cfg.grid, cfg.grid, cfg.embed_dim)).astype(np.float32)
    for i in range(cfg.depth):
        window = 0 if i in cfg.global_attn_indexes else cfg.window_size
        want = np.asarray(JE._block_forward(
            jnp.asarray(x).astype(jnp.bfloat16),
            jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                         params["blocks"][i]),
            cfg.heads, window).astype(jnp.float32))
        with torch.no_grad():
            got = E._block_forward(
                torch.from_numpy(x).bfloat16(),
                E._cast(tparams["blocks"][i], torch.bfloat16), cfg.heads,
                window, use_flash=False).float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp, i
        assert (got != want).mean() < 0.01, i

    img = np.random.default_rng(2).normal(
        size=(2, cfg.img_size, cfg.img_size, 3)).astype(np.float32)
    want = np.asarray(JE.forward(jax.tree.map(jnp.asarray, params), img,
                                 JM.SAM_TINY.encoder, jnp.bfloat16,
                                 use_flash=False).astype(jnp.float32))
    with torch.no_grad():
        got = E.forward(tparams, torch.from_numpy(img), cfg, torch.bfloat16,
                        use_flash=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=4e-2)


def test_window_partition_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 10, 14, 8)).astype(np.float32))
    wins, hw_pad = E._window_partition(x, 4)
    assert wins.shape == (2 * 3 * 4, 4, 4, 8) and hw_pad == (12, 16)
    jwins, _ = JE._window_partition(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))
    back = E._window_unpartition(wins, 4, hw_pad, (10, 14))
    np.testing.assert_array_equal(back.numpy(), x.numpy())


def test_conv_transpose_keeps_jax_orientation():
    """``lax.conv_transpose`` does not flip the kernel; the port's upscale
    matches it, and torch's ``conv_transpose2d`` on the unflipped kernel
    would not."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
    w = rng.normal(size=(2, 2, 6, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_transpose(
        x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = D.conv_transpose_2x2(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    flipped = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(2, 3, 0, 1), stride=2
    ).permute(0, 2, 3, 1).numpy()
    assert np.abs(flipped - want).max() > 0.1


def test_decode_masks_matches_jax():
    cfg = JM.SAM_TINY.decoder
    params = D.init_params(M.SAM_TINY.decoder, seed=4)
    rng = np.random.default_rng(6)
    g = JM.SAM_TINY.encoder.grid
    emb = rng.normal(size=(2, g, g, cfg.embed_dim)).astype(np.float32)
    pts = rng.uniform(size=(2, 3, 2)).astype(np.float32)
    lbl = np.array([[1, 0, 1], [1, 1, -1]], np.float32)
    want_m, want_i = JD.decode_masks(jax.tree.map(jnp.asarray, params), emb,
                                     pts, lbl, cfg)
    got_m, got_i = D.decode_masks(M.params_from_jax(params),
                                  *map(torch.from_numpy, (emb, pts, lbl)),
                                  M.SAM_TINY.decoder)
    assert got_m.shape == (2, 4, 4 * g, 4 * g) and got_i.shape == (2, 4)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-5)


def test_predict_matches_jax(predictors):
    jsam, tsam = predictors
    img = np.random.default_rng(7).integers(0, 255, (96, 120, 3), np.uint8)
    jsam.set_image(img)
    tsam.set_image(img)
    for pts, lbl, multi in (([[60.0, 48.0]], [1], True),
                            ([[10.0, 10.0], [90.0, 70.0]], [1, 0], True),
                            ([[32.0, 32.0]], [1], False)):
        jm, js = jsam.predict(np.array(pts), np.array(lbl), multi)
        tm, ts = tsam.predict(np.array(pts), np.array(lbl), multi)
        assert tm.shape == jm.shape and tm.dtype == bool
        np.testing.assert_allclose(ts, js, atol=1e-5)
        assert (tm == jm).mean() > 0.999


def test_segment_batch_matches_jax_and_per_image_predict(predictors):
    jsam, tsam = predictors
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 255, (60, 80, 3), dtype=np.uint8),
            rng.integers(0, 255, (90, 50, 3), dtype=np.uint8)]
    got = tsam.segment_batch(imgs)
    want = jsam.segment_batch(imgs)
    for img, (tm, ti), (jm, ji) in zip(imgs, got, want):
        np.testing.assert_allclose(ti, ji, atol=1e-5)
        assert (tm == jm).mean() > 0.999
        h, w = img.shape[:2]
        tsam.set_image(img)
        sm, si = tsam.predict(np.array([[w / 2, h / 2]]), np.array([1]))
        np.testing.assert_allclose(ti, si, atol=1e-5)
        assert (tm == sm).mean() > 0.999
    with pytest.raises(ValueError, match="prompt points"):
        tsam.segment_batch(imgs, point_coords=[np.zeros((2, 2)),
                                               np.zeros((1, 2))])


def _crop_tree(root, seed):
    """The tree of tests/test_sam.py: two 70 × 90 images and one file that
    does not decode."""
    rng = np.random.default_rng(seed)
    src = root / "dataset_cropped" / "original_images" / "cls"
    src.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (70, 90, 3), dtype=np.uint8)
                        ).save(src / f"c{i}.jpg")
    (src / "broken.jpg").write_bytes(b"nope")


@pytest.mark.parametrize("batch_size", [8, 1])
def test_run_auto_segment_matches_jax(tmp_path, predictors, batch_size):
    jsam, tsam = predictors
    _crop_tree(tmp_path, seed=9)
    results = {}
    for name, mod, sam in (("jax", jseg, jsam), ("torch", seg, tsam)):
        results[name] = mod.run_auto_segment(mod.SegmentConfig(
            src_root=str(tmp_path / "dataset_cropped"),
            dst_root=str(tmp_path / f"dataset_segmented_{name}")), sam,
            batch_size=batch_size)
    assert (results["torch"].n_segmented, results["torch"].n_failed) == \
        (results["jax"].n_segmented, results["jax"].n_failed) == (2, 1)
    outs = {n: tmp_path / f"dataset_segmented_{n}" / "original_images" / "cls"
            for n in results}
    names = sorted(p.name for p in outs["torch"].iterdir())
    assert names == sorted(p.name for p in outs["jax"].iterdir()) == \
        ["c0.png", "c1.png"]
    for name in names:
        got = np.asarray(Image.open(outs["torch"] / name))
        want = np.asarray(Image.open(outs["jax"] / name))
        assert got.shape == want.shape == (70, 90, 4)
        np.testing.assert_array_equal(got[..., :3], want[..., :3])
        assert (got[..., 3] == want[..., 3]).mean() > 0.999


def test_run_auto_segment_without_segment_batch(tmp_path, predictors):
    """A predictor with only set_image/predict takes the per-image loop."""
    _, tsam = predictors

    class PerImage:
        set_image = tsam.set_image
        predict = tsam.predict

    _crop_tree(tmp_path, seed=10)
    res = seg.run_auto_segment(seg.SegmentConfig(
        src_root=str(tmp_path / "dataset_cropped"),
        dst_root=str(tmp_path / "dataset_segmented")), PerImage())
    assert (res.n_segmented, res.n_failed) == (2, 1)


def test_manual_session(tmp_path, predictors):
    _, tsam = predictors
    d = tmp_path / "cls"
    d.mkdir()
    rng = np.random.default_rng(11)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (50, 60, 3), dtype=np.uint8)
                        ).save(d / f"m{i}.jpg")
    s = seg.ManualSegmentSession(tsam, d)
    assert len(s.items) == 3
    s.load()
    masks, scores = s.click(30, 25)
    assert masks.shape == (3, 50, 60)
    out = s.save(int(np.argmax(scores)))
    assert out.name == "m0_rmbg.png"
    assert np.asarray(Image.open(out)).shape == (50, 60, 4)
    # Unprocessed-only listing skips m0 now (22m:76-84 stem diff).
    assert [p.name for p in seg.ManualSegmentSession(tsam, d).items] == \
        ["m1.jpg", "m2.jpg"]
    assert len(seg.ManualSegmentSession(tsam, d,
                                        only_unprocessed=False).items) == 3
    s.next()
    assert s.current.name == "m1.jpg"


def test_predictor_on_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.SamPredictor(M.init_params(M.SAM_TINY), M.SAM_TINY)
