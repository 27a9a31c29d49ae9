"""Port parity: TinyDet (``models/detector/tinydet.py``) and its training
loop (``train/detector_loop.py``), at ``tests/test_detector.py``'s
config (64 px, channels 16–32, head 32).

Tolerances: ``forward`` 1e-4 (f32 convs summed in another order), decoded
boxes 1e-3 px and scores 1e-5, one step's loss 1e-5 relative and its
gradients 1e-4 relative to each tensor's largest. Parameters after Adam
steps are not compared elementwise (the first step is ±lr per element,
and a gradient near 0 may flip sign between the stacks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from retrieval_based_object_detection_tpu.models.detector import (
    tinydet as jt,
)
from retrieval_based_object_detection_tpu.train import detector_loop as JDL
from retrieval_based_object_detection_tpu_torch.models.detector import (
    tinydet as tt,
)
from retrieval_based_object_detection_tpu_torch.pipelines import (
    labeling as TL,
)
from retrieval_based_object_detection_tpu_torch.train import (
    detector_loop as TDL,
)

JCFG = jt.TinyDetConfig(image_size=64, channels=(16, 32), head_dim=32,
                        max_det=8)
TCFG = tt.TinyDetConfig(image_size=64, channels=(16, 32), head_dim=32,
                        max_det=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file: its training loops and flood
    fills are many small ops, and with the suite's workers sharing the
    cores torch's threads would mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed=0, b=2):
    rng = np.random.default_rng(seed)
    img = np.full((b, 64, 64, 3), 230.0, np.float32)
    for i in range(b):
        y, x = rng.integers(4, 28, 2)
        img[i, y:y + 28, x:x + 30] = rng.integers(0, 200, 3)
    return img + rng.uniform(0, 8, img.shape).astype(np.float32)


def _gt():
    boxes = np.array([[[8, 6, 40, 36], [30, 30, 60, 58], [0, 0, 0, 0]],
                      [[20, 10, 50, 44], [0, 0, 0, 0], [0, 0, 0, 0]]],
                     np.float32)
    valid = np.array([[True, True, False], [True, False, False]])
    return boxes, valid


@pytest.mark.parametrize("cfg", [(JCFG, TCFG), (jt.TinyDetConfig(),
                                                 tt.TinyDetConfig())])
def test_init_params_bit_for_bit(cfg):
    jcfg, tcfg = cfg
    ours = tt.init_params(tcfg, seed=11)
    theirs = jt.init_params(jcfg, seed=11)
    lo = jax.tree_util.tree_leaves(ours)
    lt = jax.tree_util.tree_leaves(theirs)
    assert len(lo) == len(lt)
    for a, b in zip(lo, lt):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert [tuple(t.shape) for t in tt.leaves(
        tt.params_from_jax(ours, device="cpu"))] == \
        [tuple(p.shape) for p in tt.leaves(tt.params_from_jax(
            theirs, device="cpu"))]


def test_forward_matches_jax():
    jp = jt.init_params(JCFG, seed=0)
    tp = tt.params_from_jax(jp, device="cpu")
    x = _images()
    jobj, jltrb = jt.forward(jp, jnp.asarray(x), JCFG)
    tobj, tltrb = tt.forward(tp, torch.from_numpy(x), TCFG)
    assert tuple(tobj.shape) == jobj.shape == (2, 16, 16)
    assert tuple(tltrb.shape) == jltrb.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(tobj.detach().numpy(), np.asarray(jobj),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tltrb.detach().numpy(), np.asarray(jltrb),
                               atol=1e-4, rtol=1e-4)


def test_same_padding_and_gelu_follow_jax():
    """XLA's "SAME" puts the smaller half of a stride-2 3×3 window's pad
    low; ``nn.Conv2d(padding=1)`` pads both sides and shifts the map by a
    pixel. ``jax.nn.gelu`` is the tanh form, not torch's default erf."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tt._conv(xt, torch.from_numpy(k), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    naive = F.conv2d(xt, torch.from_numpy(k).permute(3, 2, 0, 1), stride=2,
                     padding=1).permute(0, 2, 3, 1).numpy()
    assert np.abs(naive - want).max() > 1e-2
    v = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(v), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(v)), atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(v)).numpy()
                  - np.asarray(jax.nn.gelu(v))).max() > 1e-4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_matches_jax(seed):
    jp = jt.init_params(JCFG, seed=seed)
    tp = tt.params_from_jax(jp, device="cpu")
    x = _images(seed)
    for conf in (0.0, 0.005):
        jb, js = jt.decode(jp, jnp.asarray(x), JCFG, conf_threshold=conf)
        tb, ts = tt.decode(tp, torch.from_numpy(x), TCFG,
                           conf_threshold=conf)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-3,
                                   rtol=0)


def test_decode_ties_and_nms_follow_jax():
    """Equal scores keep the lower index (``lax.top_k``), and NMS is JAX's
    K-step loop: a box suppressed by a kept box cannot suppress others."""
    cfg = tt.TinyDetConfig(image_size=64, channels=(16, 32), head_dim=32,
                           max_det=4)
    p = tt.params_from_jax(tt.init_params(cfg), device="cpu")
    with torch.no_grad():
        for t in tt.leaves(p):
            t.zero_()
        p["obj"]["bias"].fill_(2.0)         # every cell scores the same
    _, scores = tt.decode(p, torch.zeros(1, 64, 64, 3), cfg)
    # Every box is the same cell-sized square at a different centre: none
    # overlaps its neighbours above 0.5, all four are kept.
    assert (scores > 0).all()
    jp = jt.init_params(jt.TinyDetConfig(image_size=64, channels=(16, 32),
                                         head_dim=32, max_det=4))
    jp = jax.tree.map(jnp.zeros_like, jp)
    jp["obj"]["bias"] = jnp.full(1, 2.0)
    jb, js = jt.decode(jp, jnp.zeros((1, 64, 64, 3)),
                       jt.TinyDetConfig(image_size=64, channels=(16, 32),
                                        head_dim=32, max_det=4))
    tb, ts = tt.decode(p, torch.zeros(1, 64, 64, 3), cfg)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)

    a = torch.tensor([[[0, 0, 10, 10], [1, 0, 11, 10], [2, 0, 12, 10],
                       [50, 50, 60, 60]]], dtype=torch.float32)
    iou = tt._pairwise_iou(a, a)
    np.testing.assert_allclose(iou.numpy(),
                               np.asarray(jt._pairwise_iou(a.numpy(),
                                                           a.numpy())),
                               atol=1e-7)


def test_loss_and_one_step_gradients_match_jax():
    jp = jt.init_params(JCFG, seed=4)
    tp = tt.params_from_jax(jp, device="cpu")
    for t in tt.leaves(tp):
        t.requires_grad_(True)
    x = _images(4)
    boxes, valid = _gt()
    (jl, jaux), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
        jp, jnp.asarray(x), jnp.asarray(boxes), jnp.asarray(valid), JCFG)
    tl, taux = tt.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(boxes),
                          torch.from_numpy(valid), TCFG)
    tg = torch.autograd.grad(tl, tt.leaves(tp))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("focal", "iou_loss", "n_pos"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=1e-5)
    jleaves = tt.leaves(jg)
    assert len(jleaves) == len(tg)
    for t, j in zip(tg, jleaves):
        j = np.asarray(j)
        scale = max(np.abs(j).max(), 1e-12)
        assert np.abs(t.numpy() - j).max() <= 1e-4 * scale


def test_train_step_lowers_the_loss_like_jax():
    """A few Adam steps on one batch: both stacks lower the loss, and to
    within 10% of each other."""
    jp = jt.init_params(JCFG, seed=5)
    tp = tt.params_from_jax(jp, device="cpu")
    x = _images(5)
    boxes, valid = _gt()
    jstep, jinit = jt.make_train_step(JCFG, 2e-3)
    tstep, tinit = tt.make_train_step(TCFG, 2e-3)
    jopt, topt = jinit(jp), tinit(tp)
    jlosses, tlosses = [], []
    for _ in range(12):
        jp, jopt, jm = jstep(jp, jopt, x, boxes, valid)
        tp, topt, tm = tstep(tp, topt, x, boxes, valid)
        jlosses.append(float(jm["loss"]))
        tlosses.append(float(tm["loss"]))
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
    assert tlosses[-1] < 0.7 * tlosses[0] and jlosses[-1] < 0.7 * jlosses[0]
    assert abs(tlosses[-1] - jlosses[-1]) <= 0.1 * jlosses[-1]


@pytest.fixture
def labeled_tree(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "original_images" / "cls"
    d.mkdir(parents=True)
    for i in range(8):
        img = np.full((96, 128, 3), 235, np.uint8)
        img[24:72, 32:96] = (200, 40, 40)
        img = np.clip(img + rng.integers(0, 8, img.shape), 0, 255
                      ).astype(np.uint8)
        Image.fromarray(img).save(d / f"i{i}.jpg")
    (d / "broken.jpg").write_bytes(b"not a jpeg")
    res = TL.run_labeling(TL.LabelConfig(root_dir=str(tmp_path),
                                         img_type="original", batch_size=8,
                                         det_size=128),
                          device="cpu")
    assert res.labeled == 8 and res.failed == 1
    (d / "broken.txt").write_text("0 0.5 0.5 0.5 0.5\n")
    return tmp_path


def test_fit_detector_and_detect(labeled_tree, capsys):
    """The JAX test's recipe (150 epochs of one batch at 3e-3) on the same
    tree: the port learns the box too. One broken labeled file shrinks a
    batch, which the refill brings back to full size."""
    params, metrics = TDL.fit_detector(
        TCFG, TDL.DetFitConfig(root_dir=str(labeled_tree), epochs=150,
                               batch_size=8, learning_rate=3e-3),
        device="cpu")
    assert np.isfinite(metrics["loss"]) and metrics["n_pos"] > 0
    assert "refill" in capsys.readouterr().err
    det = TDL.TinyDetDetector(params, TCFG, device="cpu")
    canvas, scale = TL.letterbox(np.asarray(Image.open(
        labeled_tree / "original_images" / "cls" / "i0.jpg")), 64)
    boxes, scores = det(canvas[None])
    assert boxes.shape == (1, 8, 4) and scores.shape == (1, 8)
    assert scores[0, 0] > 0.25, scores[0]
    x1, y1, x2, y2 = boxes[0, 0] / scale
    assert x1 < 45 and x2 > 80 and y1 < 38 and y2 > 60, boxes[0, 0] / scale


def test_detector_wraps_jax_params_like_jax():
    jp = jt.init_params(JCFG, seed=6)
    canvases = _images(6).astype(np.uint8)
    jb, js = JDL.TinyDetDetector(jp, JCFG, conf_threshold=0.0)(canvases)
    tb, ts = TDL.TinyDetDetector(jp, TCFG, conf_threshold=0.0,
                                 device="cpu")(canvases)
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tb, np.asarray(jb), atol=1e-3, rtol=0)
    assert isinstance(tb, np.ndarray) and isinstance(ts, np.ndarray)


def test_fit_detector_errors(tmp_path, monkeypatch):
    (tmp_path / "original_images" / "c").mkdir(parents=True)
    with pytest.raises(ValueError, match="no labeled"):
        TDL.fit_detector(TCFG, TDL.DetFitConfig(root_dir=str(tmp_path)),
                         device="cpu")
    with pytest.raises(ValueError, match="no labeled"):
        JDL.fit_detector(JCFG, JDL.DetFitConfig(root_dir=str(tmp_path)))
    d = tmp_path / "original_images" / "c"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(d / "a.jpg")
    (d / "a.txt").write_text("0 0.5 0.5 0.5 0.5\n")
    with pytest.raises(ValueError, match="exceeds labeled set"):
        TDL.fit_detector(TCFG, TDL.DetFitConfig(root_dir=str(tmp_path)),
                         device="cpu")
    # Without a GPU the default device raises; nothing falls back.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDL.TinyDetDetector(tt.init_params(TCFG), TCFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDL.fit_detector(TCFG, TDL.DetFitConfig(root_dir=str(tmp_path),
                                                batch_size=1))
