"""Port parity: the front of the pipeline, stage by stage and as a slice.

The same numpy-seeded source tree goes through both packages: ``run_ingest``
→ ``run_labeling`` (the saliency proposer, and a stub detector) →
``run_crop`` → ``run_augment``, then the crops are embedded
(``embed_tree``), the delegates built, and a ``RetrievalDetector`` serves
with TinyDet as its external detector. Expected equalities: the same file
names, counts and label text, the same JPEG/PNG bytes where the pixels
are bit for bit (ingest, crop, brightness, rotation); the blur variant to
one grey level on ≤0.1% of pixels; the noise variants by their own
determinism (their bits are the port's, not threefry's); detections by
class name, box (1e-3 px) and similarity (2e-2, bf16 serving).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from retrieval_based_object_detection_tpu.gallery.store import Gallery as JGallery
from retrieval_based_object_detection_tpu.models.clip import model as jclip
from retrieval_based_object_detection_tpu.models.detector import (
    tinydet as jtd,
)
from retrieval_based_object_detection_tpu.pipelines import augment as JA
from retrieval_based_object_detection_tpu.pipelines import crop as JC
from retrieval_based_object_detection_tpu.pipelines import delegates as jdp
from retrieval_based_object_detection_tpu.pipelines import embed as jep
from retrieval_based_object_detection_tpu.pipelines import ingest as JI
from retrieval_based_object_detection_tpu.pipelines import labeling as JL
from retrieval_based_object_detection_tpu.pipelines import serve as jsv
from retrieval_based_object_detection_tpu.train import detector_loop as JDL
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
)
from retrieval_based_object_detection_tpu_torch.models.clip import (
    model as tclip,
)
from retrieval_based_object_detection_tpu_torch.models.detector import (
    tinydet as ttd,
)
from retrieval_based_object_detection_tpu_torch.pipelines import (
    augment as TA,
)
from retrieval_based_object_detection_tpu_torch.pipelines import crop as TC
from retrieval_based_object_detection_tpu_torch.pipelines import (
    delegates as tdp,
)
from retrieval_based_object_detection_tpu_torch.pipelines import embed as tep
from retrieval_based_object_detection_tpu_torch.pipelines import ingest as TI
from retrieval_based_object_detection_tpu_torch.pipelines import (
    labeling as TL,
)
from retrieval_based_object_detection_tpu_torch.pipelines import serve as tsv
from retrieval_based_object_detection_tpu_torch.train import (
    detector_loop as TDL,
)

COLORS = {"blue": (40, 40, 210), "green": (40, 190, 60),
          "red": (210, 40, 40)}
CLIP = dict(image_size=64, patch_size=16, width=64, layers=2, heads=2,
            embed_dim=32)
DET = dict(image_size=64, channels=(16, 32), head_dim=32, max_det=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file: its training loops and flood
    fills are many small ops, and with the suite's workers sharing the
    cores torch's threads would mostly wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def photo(color, rng, size=(120, 160)):
    """A studio shot: one coloured product at a random box; → (image,
    box xyxy)."""
    h, w = size
    img = np.full((h, w, 3), 232, np.uint8)
    bh, bw = rng.integers(h // 3, h // 2), rng.integers(w // 3, w // 2)
    y, x = rng.integers(8, h - bh - 8), rng.integers(8, w - bw - 8)
    img[y:y + bh, x:x + bw] = color
    img = np.clip(img + rng.integers(0, 9, img.shape), 0, 255).astype(
        np.uint8)
    return img, (x, y, x + bw, y + bh)


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    base = tmp_path_factory.mktemp("front")
    rng = np.random.default_rng(0)
    boxes = {}
    for cls, col in COLORS.items():
        d = base / "dataset_heic" / "original_images" / cls
        d.mkdir(parents=True)
        for i in range(4):
            img, box = photo(col, rng)
            Image.fromarray(img).save(d / f"IMG_{i}.png")
            boxes[(cls, f"IMG_{i}")] = box
    d = base / "dataset_heic" / "original_images" / "red"
    Image.fromarray(photo(COLORS["red"], rng)[0]).save(d / "IMG_0 (2).png")
    (d / "IMG_9.png").write_bytes(b"not a png")
    return base, boxes


@pytest.fixture(scope="module")
def stages(source):
    """Ingest, saliency labeling and crop in each package, each into its
    own tree."""
    base, _ = source
    out = {}
    for name, I, L, C, kw in (("jax", JI, JL, JC, {}),
                              ("port", TI, TL, TC, {"device": "cpu"})):
        root = base / name
        ing = I.run_ingest(I.IngestConfig(
            src_root=str(base / "dataset_heic"),
            dst_root=str(root / "dataset_jpeg")))
        lab = L.run_labeling(L.LabelConfig(
            root_dir=str(root / "dataset_jpeg"), batch_size=5, det_size=128),
            **kw)
        crop = C.run_crop(C.CropConfig(
            src_root=str(root / "dataset_jpeg"),
            dst_root=str(root / "dataset_cropped")))
        out[name] = dict(root=root, ingest=ing, label=lab, crop=crop)
    return out


def test_ingest_matches_jax(stages):
    j, t = stages["jax"], stages["port"]
    assert t["ingest"] == TI.IngestResult(
        n_converted=12, n_skipped_existing=0, n_skipped_duplicate=1,
        n_failed=1, n_name_collisions=0)
    assert vars(t["ingest"]) == vars(j["ingest"])
    assert _files(t["root"] / "dataset_jpeg").keys() == \
        _files(j["root"] / "dataset_jpeg").keys()
    for name in ("blue/IMG_0.jpeg", "red/IMG_3.jpeg"):
        rel = Path("original_images") / name
        assert (t["root"] / "dataset_jpeg" / rel).read_bytes() == \
            (j["root"] / "dataset_jpeg" / rel).read_bytes()


def test_ingest_is_idempotent_and_loud_on_heic(tmp_path, stages, source):
    base, _ = source
    again = TI.run_ingest(TI.IngestConfig(
        src_root=str(base / "dataset_heic"),
        dst_root=str(stages["port"]["root"] / "dataset_jpeg")))
    assert again.n_skipped_existing == 12 and again.n_converted == 0
    assert TI.is_duplicate_name("IMG_1 (2).HEIC")
    assert not TI.is_duplicate_name("IMG_12.HEIC")
    d = tmp_path / "src" / "original_images" / "c"
    d.mkdir(parents=True)
    (d / "IMG_1.HEIC").write_bytes(b"\0" * 64)
    if TI._ensure_heif():
        pytest.skip("pillow-heif is installed here")
    for I in (TI, JI):
        with pytest.raises(RuntimeError, match="pillow-heif"):
            I.run_ingest(I.IngestConfig(src_root=str(tmp_path / "src"),
                                        dst_root=str(tmp_path / "dst")))


def test_saliency_labels_match_jax(stages, source):
    _, boxes = source
    j, t = stages["jax"], stages["port"]
    assert vars(t["label"]) == {**vars(j["label"]), "not_detected":
                                [p.replace("/jax/", "/port/") for p in
                                 j["label"].not_detected]}
    assert t["label"].labeled == 12
    tl = {k: v for k, v in _files(t["root"] / "dataset_jpeg").items()
          if k.endswith(".txt")}
    jl = {k: v for k, v in _files(j["root"] / "dataset_jpeg").items()
          if k.endswith(".txt")}
    assert tl == jl
    assert tl["original_images/classes.txt"] == b"blue\ngreen\nred\n"
    # The labels find the products.
    for (cls, stem), (x1, y1, x2, y2) in boxes.items():
        line = (t["root"] / "dataset_jpeg" / "original_images" / cls /
                f"{stem}.txt").read_text().split()
        assert line[0] == str(sorted(COLORS).index(cls))
        xc, yc, bw, bh = (float(v) for v in line[1:])
        assert abs(xc * 160 - (x1 + x2) / 2) < 8
        assert abs(yc * 120 - (y1 + y2) / 2) < 8


def test_labeling_with_a_stub_detector_matches_jax(tmp_path, source):
    """Any detector callable: top-K by score past the gate, boxes mapped
    back through the letterbox scale, 6-decimal YOLO lines."""
    base, _ = source

    def stub(images):
        b = images.shape[0]
        boxes = np.tile(np.array([[4.0, 6.0, 40.0, 50.0],
                                  [10.0, 12.5, 60.0, 63.0],
                                  [0.0, 0.0, 5.0, 5.0]], np.float32),
                        (b, 1, 1))
        scores = np.tile(np.array([0.3, 0.9, 0.1], np.float32), (b, 1))
        return boxes, scores

    texts = {}
    for name, I, L in (("jax", JI, JL), ("port", TI, TL)):
        root = tmp_path / name
        I.run_ingest(I.IngestConfig(src_root=str(base / "dataset_heic"),
                                    dst_root=str(root)))
        res = L.run_labeling(L.LabelConfig(root_dir=str(root), det_size=64,
                                           max_object_count=None,
                                           classes=["green", "red"]), stub)
        assert res.labeled == 8 and res.failed == 0
        texts[name] = {k: v for k, v in _files(root).items()
                       if k.endswith(".txt")}
    assert texts["port"] == texts["jax"]
    first = texts["port"]["original_images/green/IMG_0.txt"].decode()
    assert first.startswith("1 ") and len(first.splitlines()) == 2


def test_crop_matches_jax(stages):
    j, t = stages["jax"], stages["port"]
    assert vars(t["crop"]) == vars(j["crop"])
    assert t["crop"].n_objects == 12
    assert _files(t["root"] / "dataset_cropped") == \
        _files(j["root"] / "dataset_cropped")


@pytest.fixture(scope="module")
def augmented(stages, tmp_path_factory):
    base = tmp_path_factory.mktemp("aug")
    src = stages["port"]["root"] / "dataset_cropped"
    seg = base / "seg" / "original_images" / "blue"
    seg.mkdir(parents=True)
    rgba = np.random.default_rng(3).integers(0, 256, (30, 41, 4), np.uint8)
    Image.fromarray(rgba, "RGBA").save(seg / "seg.png")
    out = {}
    for name, A, kw in (("jax", JA, {}), ("port", TA, {"device": "cpu"}),
                        ("port2", TA, {"device": "cpu"})):
        for tag, root, classes in (("crops", src, ["blue"]),
                                   ("seg", base / "seg", None)):
            cfg = A.AugmentConfig(src_root=str(root),
                                  dst_root=str(base / name / tag),
                                  classes=classes, seed=5)
            out[(name, tag)] = (A.run_augment(cfg, **kw), base / name / tag,
                                cfg)
    return out


def _deterministic(name: str) -> bool:
    return "brightness" in name or "_rot" in name


def test_augment_writes_the_grid_like_jax(augmented):
    for tag, n_in in (("crops", 4), ("seg", 1)):
        tres, troot, tcfg = augmented[("port", tag)]
        jres, jroot, _ = augmented[("jax", tag)]
        assert vars(tres) == vars(jres) == {"n_inputs": n_in,
                                            "n_written": 26 * n_in,
                                            "n_failed": 0}
        tf, jf = _files(troot), _files(jroot)
        assert tf.keys() == jf.keys()
        src_root = Path(tcfg.src_root)
        want = set()
        for img in src_root.rglob("*"):
            if img.suffix in (".png", ".jpeg") and (
                    tcfg.classes is None or img.parent.name in tcfg.classes):
                rel = img.parent.relative_to(src_root)
                want |= {str(rel / n) for n in TA.variant_names(
                    img.stem, img.suffix, tcfg)}
        assert want == tf.keys()
        for k in tf:
            if _deterministic(k):
                assert tf[k] == jf[k], k


def test_augment_blur_and_noise_variants(augmented):
    tres, troot, _ = augmented[("port", "seg")]
    _, jroot, _ = augmented[("jax", "seg")]
    _, t2root, _ = augmented[("port2", "seg")]
    for lv in (1, 2, 3):
        rel = Path("original_images") / "blue" / f"seg_blurnoise_{lv}.png"
        a = np.asarray(Image.open(troot / rel), np.int16)
        b = np.asarray(Image.open(jroot / rel), np.int16)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 1e-3
    # The noise variants: the same bytes from a second seeded run (the
    # thread schedule does not matter), noise of the stated size.
    assert _files(troot) == _files(t2root)
    _, croot, _ = augmented[("port", "crops")]
    _, c2root, _ = augmented[("port2", "crops")]
    assert _files(croot) == _files(c2root)
    src = np.asarray(Image.open(troot.parent.parent / "seg" /
                                "original_images" / "blue" / "seg.png"),
                     np.float32)
    g = np.asarray(Image.open(troot / "original_images" / "blue" /
                              "seg_gaussiannoise_3.png"), np.float32)
    assert 0.3 < np.abs(g - src).mean() < 1.0   # ~0.75·0.8 grey levels
    s = np.asarray(Image.open(troot / "original_images" / "blue" /
                              "seg_snpnoise_3.png"), np.float32)
    hit = (s != src).any(-1)
    assert 0 < hit.mean() < 0.1
    assert set(np.unique(s[hit])) <= {0.0, 255.0}


def test_image_generator_depends_on_seed_and_index():
    a = torch.rand(4, generator=TA.image_generator(0, 1))
    assert torch.equal(a, torch.rand(4, generator=TA.image_generator(0, 1)))
    assert not torch.equal(a, torch.rand(
        4, generator=TA.image_generator(0, 2)))
    assert not torch.equal(a, torch.rand(
        4, generator=TA.image_generator(1, 1)))


def _numpy_params(jparams):
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in jparams.items()}


def test_whole_front_slice_serves_like_jax(stages, source, tmp_path):
    """The crops embedded into a gallery by each package, the delegates
    built, and a RetrievalDetector with TinyDet as its external detector
    (JAX-trained weights, the same in both) answering 6 requests."""
    jroot = stages["jax"]["root"]
    det_cfg = jtd.TinyDetConfig(**DET)
    det_params, _ = JDL.fit_detector(det_cfg, JDL.DetFitConfig(
        root_dir=str(jroot / "dataset_jpeg"), epochs=60, batch_size=4,
        learning_rate=3e-3))
    jcfg = jclip.CLIPVisionConfig(**CLIP)
    jparams = jclip.init_params(jcfg, seed=2)
    tparams = tclip.params_from_jax(_numpy_params(jparams))
    tcfg = tclip.CLIPVisionConfig(**CLIP)
    jg = JGallery("front", dim=CLIP["embed_dim"])
    tg = TGallery("front", dim=CLIP["embed_dim"], device="cpu")
    for name, ep, g, enc in (
            ("jax", jep, jg, jep.make_encoder(jparams, jcfg)),
            ("port", tep, tg, tep.make_encoder(tparams, tcfg, device="cpu"))):
        res = ep.embed_tree(g, enc, ep.EmbedConfig(
            root_dir=str(stages[name]["root"] / "dataset_cropped"),
            img_type="original", image_size=64, batch_size=8))
        assert res.total == 12
    jdp.build_delegates(jg)
    tdp.build_delegates(tg)

    jdet = jsv.RetrievalDetector(jparams, jg, jcfg,
                                 detector=JDL.TinyDetDetector(det_params,
                                                              det_cfg))
    tdet = tsv.RetrievalDetector(
        tparams, tg, tcfg, device="cpu",
        detector=TDL.TinyDetDetector(det_params, ttd.TinyDetConfig(**DET),
                                     device="cpu"))
    rng = np.random.default_rng(9)
    truth = ["red", "blue", "green", "green", "blue", "red"]
    canvases = np.stack([TL.letterbox(photo(COLORS[c], rng)[0], 64)[0]
                         for c in truth])
    jout = jdet.detect(jnp.asarray(canvases))
    tout = tdet.detect(canvases)
    assert [d["class_name"] for d in tout] == [d["class_name"] for d in jout]
    assert sum(d["class_name"] == c for d, c in zip(tout, truth)) >= 5
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t["box"], j["box"], atol=1e-3)
        assert abs(t["similarity"] - j["similarity"]) < 2e-2
        assert len(t["detections"]) == len(j["detections"])
