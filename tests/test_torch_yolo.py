"""Port parity: YOLOv8 (``models/yolo``), at ``tests/test_yolo.py``'s
``TINY`` (width 0.25, 7 classes, 64–96 px).

Both packages get the same numpy-seeded weights (``init_params``, equal
bit for bit) or the same official-layout checkpoint, and the same images.
Tolerances: the raw heads atol 2e-4 / rtol 1e-3 (``tests/test_yolo.py``'s
own), decoded boxes 1e-2 px, class probabilities 1e-4; the host NMS and
postprocess are equal on equal inputs.
"""

import io
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.models.yolo import convert as JC
from retrieval_based_object_detection_tpu.models.yolo import detector as JD
from retrieval_based_object_detection_tpu.models.yolo import model as JY
from retrieval_based_object_detection_tpu_torch.models.yolo import (
    convert as TC,
)
from retrieval_based_object_detection_tpu_torch.models.yolo import (
    detector as TD,
)
from retrieval_based_object_detection_tpu_torch.models.yolo import (
    download as TDL,
)
from retrieval_based_object_detection_tpu_torch.models.yolo import model as TY
from retrieval_based_object_detection_tpu_torch.utils import download as TUD

TINY = TY.YoloConfig(depth_mult=0.33, width_mult=0.25, max_channels=1024,
                     num_classes=7)
JTINY = JY.YoloConfig(depth_mult=0.33, width_mult=0.25, max_channels=1024,
                      num_classes=7)
HEAD_TOL = {"atol": 2e-4, "rtol": 1e-3}


def _randomize_bn(model: TY.YoloV8, seed: int = 0) -> TY.YoloV8:
    """Random BN statistics and conv biases, so the scale-and-shift and
    every bias are exercised (``init_params`` has identity BN)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TY.BatchNorm):
                m.weight.uniform_(0.6, 1.4, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
                m.running_mean.normal_(0, 0.2, generator=g)
                m.running_var.uniform_(0.6, 1.4, generator=g)
            elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.normal_(0, 0.05, generator=g)
    return model


@pytest.fixture(scope="module")
def seeded():
    params = JY.init_params(JTINY, seed=3)
    model = TY.build_model(TY.params_from_jax(TY.init_params(TINY, seed=3)),
                           TINY, device="cpu")
    return params, model


@pytest.fixture(scope="module")
def official(tmp_path_factory):
    """An official-layout container: the ultralytics DetectionModel OBJECT
    pickled under "model", its class unimportable at load time."""
    model = _randomize_bn(TY.build_model(
        TY.params_from_jax(TY.init_params(TINY, seed=5)), TINY,
        device="cpu"))
    mod = types.ModuleType("ultralytics_fake_tasks")
    exec("import torch.nn as nn\n"
         "class DetectionModel(nn.Module):\n    pass\n", mod.__dict__)
    sys.modules["ultralytics_fake_tasks"] = mod
    try:
        dm = mod.DetectionModel()
        dm.model = model.model
        path = tmp_path_factory.mktemp("yolo") / "yolov8_tiny.pt"
        torch.save({"model": dm, "epoch": -1}, path)
    finally:
        del sys.modules["ultralytics_fake_tasks"]
    return path


@pytest.mark.parametrize("name", ["tiny", "yolov8s"])
def test_init_params_bit_for_bit(name):
    tcfg = TINY if name == "tiny" else TY.VARIANTS[name]
    jcfg = JTINY if name == "tiny" else JY.VARIANTS[name]
    ours = jax.tree_util.tree_leaves(TY.init_params(tcfg, seed=7))
    theirs = jax.tree_util.tree_leaves(JY.init_params(jcfg, seed=7))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_variants_and_spec_are_the_references():
    assert TY.SPEC == JY.SPEC
    for name, cfg in TY.VARIANTS.items():
        assert dataclass_tuple(cfg) == dataclass_tuple(JY.VARIANTS[name])


def dataclass_tuple(cfg):
    return (cfg.depth_mult, cfg.width_mult, cfg.max_channels,
            cfg.num_classes, cfg.reg_max, cfg.strides)


def test_module_names_are_the_official_layout():
    sd = TY.YoloV8(TINY).state_dict()
    assert "model.0.conv.weight" in sd and "model.0.bn.running_var" in sd
    assert "model.2.m.0.cv1.conv.weight" in sd
    assert "model.9.cv2.bn.weight" in sd
    assert "model.22.cv2.0.2.bias" in sd and "model.22.cv3.2.2.weight" in sd
    assert "model.22.dfl.conv.weight" in sd
    assert not any(k.endswith("num_batches_tracked") for k in sd)
    assert set(TY.params_from_jax(TY.init_params(TINY))) == set(sd)


def test_raw_heads_match_jax(seeded):
    params, model = seeded
    x = np.random.default_rng(0).uniform(size=(2, 96, 96, 3)).astype(
        np.float32)
    jheads = JY.forward_features(params, jnp.asarray(x), JTINY)
    theads = TY.forward_features(model, torch.from_numpy(x))
    assert len(jheads) == len(theads) == 3
    for th, jh in zip(theads, jheads):
        assert tuple(th.shape) == jh.shape
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **HEAD_TOL)


def test_predict_matches_jax(seeded):
    params, model = seeded
    x = np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    jb, jc = JY.predict(params, jnp.asarray(x), JTINY)
    tb, tc = TY.predict(model, torch.from_numpy(x))
    assert tuple(tb.shape) == jb.shape and tuple(tc.shape) == jc.shape
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-2, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)


def test_nms_and_postprocess_equal_on_equal_inputs():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 60, (3, 200, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(2, 30, (3, 200, 2))],
                           -1).astype(np.float32)
    probs = rng.uniform(0, 1, (3, 200, 5)).astype(np.float32)
    for thr in (0.3, 0.45, 0.7):
        np.testing.assert_array_equal(
            TY.nms(boxes[0], probs[0, :, 0], thr, 300),
            JY.nms(boxes[0], probs[0, :, 0], thr, 300))
    for agnostic in (False, True):
        got = TY.postprocess(boxes, probs, 0.25, 0.45, 16, agnostic)
        want = JY.postprocess(boxes, probs, 0.25, 0.45, 16, agnostic)
        for g, w in zip(got, want):
            for k in ("boxes", "scores", "classes"):
                np.testing.assert_array_equal(g[k], w[k])
    empty = TY.postprocess(boxes, probs * 0, 0.25)
    assert all(d["boxes"].shape == (0, 4) for d in empty)


def test_official_container_through_both_converters(official):
    """The stub unpickler recovers the same state dict in both packages;
    the port loads it by name into ``YoloV8``, JAX transposes it into its
    tree, and the two give the same heads."""
    sd_t = TC.load_state_dict(official)
    sd_j = JC.load_state_dict(official)
    assert sorted(sd_t) == sorted(sd_j)
    for k in sd_t:
        np.testing.assert_array_equal(sd_t[k], sd_j[k])
    model, cfg = TC.load_torch_checkpoint(official, device="cpu")
    params, jcfg = JC.load_torch_checkpoint(official)
    assert dataclass_tuple(cfg) == dataclass_tuple(jcfg)
    assert cfg.num_classes == 7
    x = np.random.default_rng(3).uniform(size=(1, 64, 64, 3)).astype(
        np.float32)
    jheads = JY.forward_features(params, jnp.asarray(x), jcfg)
    theads = TY.forward_features(model, torch.from_numpy(x))
    for th, jh in zip(theads, jheads):
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **HEAD_TOL)


def test_plain_state_dict_checkpoints_and_rejects(tmp_path):
    model = TY.YoloV8(TINY)
    torch.save(model.state_dict(), tmp_path / "sd.pt")
    torch.save({"model": model.state_dict()}, tmp_path / "wrapped.pt")
    a, cfg = TC.load_torch_checkpoint(tmp_path / "sd.pt", device="cpu")
    b, _ = TC.load_torch_checkpoint(tmp_path / "wrapped.pt", device="cpu")
    assert cfg.num_classes == 7
    for (k, v), (_, w) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    torch.save({"foo": torch.zeros(3)}, tmp_path / "junk.pt")
    with pytest.raises(ValueError, match="model.0.conv"):
        TC.load_state_dict(tmp_path / "junk.pt")


def test_infer_config_matches_jax_for_every_variant():
    for name, cfg in TY.VARIANTS.items():
        sd = {
            "model.0.conv.weight": np.zeros((cfg.ch(64), 3, 3, 3)),
            "model.7.conv.weight": np.zeros(
                (cfg.ch(1024), cfg.ch(512), 3, 3)),
            "model.22.cv3.0.2.weight": np.zeros((80, 1, 1, 1)),
            "model.22.cv2.0.2.weight": np.zeros((64, 1, 1, 1)),
            **{f"model.2.m.{j}.cv1.conv.weight": np.zeros(1)
               for j in range(cfg.n(3))},
        }
        assert dataclass_tuple(TC.infer_config(sd)) == \
            dataclass_tuple(JC.infer_config(sd)), name


def test_detector_matches_jax_on_letterboxed_canvases(seeded):
    """numpy in, (boxes [B, K, 4], scores [B, K]) numpy out, with the
    uint8-range rescale; detections agree with JAX's by score and box."""
    params, model = seeded
    canvases = (np.random.default_rng(4).uniform(size=(2, 64, 64, 3)) * 255
                ).astype(np.uint8)
    jdet = JD.YoloDetector(params, JTINY, image_size=64, conf_threshold=0.0,
                           max_det=6)
    for source in (model, TY.init_params(TINY, seed=3)):
        tdet = TD.YoloDetector(source, TINY, image_size=64,
                               conf_threshold=0.0, max_det=6, device="cpu")
        tb, ts = tdet(canvases)
        jb, js = jdet(canvases)
        assert tb.shape == (2, 6, 4) and ts.shape == (2, 6)
        assert (np.diff(ts, axis=1) <= 1e-6).all()
        np.testing.assert_allclose(ts, js, atol=1e-4, rtol=0)
        np.testing.assert_allclose(tb, jb, atol=1e-2, rtol=0)
    with pytest.raises(ValueError, match="divisible by 32"):
        tdet(np.zeros((1, 65, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="divisible by 32"):
        TD.YoloDetector(model, TINY, image_size=100, device="cpu")


def test_detector_defaults_to_cuda(monkeypatch):
    """Without a GPU the default device raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.YoloDetector(TY.init_params(TINY), TINY, image_size=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TY.build_model(TY.params_from_jax(TY.init_params(TINY)), TINY)


class _FakeResponse:
    def __init__(self, data: bytes):
        self._io = io.BytesIO(data)
        self.headers = {"Content-Length": str(len(data))}

    def read(self, n=-1):
        return self._io.read(n)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_download_convert_detect(tmp_path, monkeypatch):
    """``from_variant`` through a mocked network: the official container
    is fetched once into the cache, converted and run."""
    model = TY.YoloV8(TINY)
    src = tmp_path / "src.pt"
    torch.save({"model": model.state_dict()}, src)
    payload = src.read_bytes()
    calls = []

    def urlopen(url, timeout=None):
        calls.append(url)
        return _FakeResponse(payload)

    monkeypatch.setattr(TUD.urllib.request, "urlopen", urlopen)
    cache = tmp_path / "model"
    path = TDL.ensure_checkpoint("yolov8n", cache_dir=cache, quiet=True)
    assert path == cache / "yolov8n.pt" and path.read_bytes() == payload
    assert calls == [TDL.YOLO_CHECKPOINT_URLS["yolov8n"]]
    det = TD.YoloDetector.from_variant("yolov8n", cache_dir=cache,
                                       image_size=64, conf_threshold=0.0,
                                       max_det=2, device="cpu")
    assert len(calls) == 1  # cached
    boxes, scores = det(np.zeros((1, 64, 64, 3), np.uint8))
    assert boxes.shape == (1, 2, 4) and np.isfinite(boxes).all()


def test_download_failures_leave_no_file(tmp_path, monkeypatch):
    def offline(url, timeout=None):
        raise TUD.urllib.error.URLError("offline test")

    monkeypatch.setattr(TUD.urllib.request, "urlopen", offline)
    with pytest.raises(TDL.CheckpointUnavailable, match="model/yolov8s.pt"):
        TDL.ensure_checkpoint("yolov8s", cache_dir=tmp_path, quiet=True)
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(KeyError):
        TDL.ensure_checkpoint("yolov9", cache_dir=tmp_path)

    monkeypatch.setattr(TUD.urllib.request, "urlopen",
                        lambda url, timeout=None: _FakeResponse(b"abc"))
    with pytest.raises(TUD.DownloadError, match="SHA256"):
        TUD.fetch_with_cache("http://x/y", tmp_path / "y.bin",
                             expected_sha256="0" * 64, quiet=True)
    assert list(tmp_path.iterdir()) == []
    import hashlib

    got = TUD.fetch_with_cache("http://x/y", tmp_path / "y.bin",
                               expected_sha256=hashlib.sha256(
                                   b"abc").hexdigest(), quiet=True)
    assert got.read_bytes() == b"abc"
