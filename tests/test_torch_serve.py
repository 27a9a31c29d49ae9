"""Port parity: the serving path, piece by piece and as a whole slice.

The whole slice runs on both packages from the same numpy-seeded weights
and images: ``embed_arrays`` → ``Gallery`` → ``build_delegates`` →
``RetrievalDetector`` behind ``serve_http`` on localhost, answering real
concurrent ``POST /detect`` requests.
"""

import concurrent.futures
import io
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from retrieval_based_object_detection_tpu.gallery.store import Gallery as JGallery
from retrieval_based_object_detection_tpu.models.clip import model as jm
from retrieval_based_object_detection_tpu.models.detector import (
    saliency as jsal,
)
from retrieval_based_object_detection_tpu.ops.image import (
    crop_resize_batch as jcrop,
)
from retrieval_based_object_detection_tpu.pipelines import delegates as jdp
from retrieval_based_object_detection_tpu.pipelines import embed as jep
from retrieval_based_object_detection_tpu.pipelines import serve as jsv
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
)
from retrieval_based_object_detection_tpu_torch.models.clip import model as tm
from retrieval_based_object_detection_tpu_torch.models.clip.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
)
from retrieval_based_object_detection_tpu_torch.models.detector import (
    saliency as tsal,
)
from retrieval_based_object_detection_tpu_torch.ops.image import (
    crop_resize_batch as tcrop,
)
from retrieval_based_object_detection_tpu_torch.pipelines import delegates as tdp
from retrieval_based_object_detection_tpu_torch.pipelines import embed as tep
from retrieval_based_object_detection_tpu_torch.pipelines import serve as tsv

CFG = dict(image_size=64, patch_size=16, width=64, layers=2, heads=2,
           embed_dim=32)
COLORS = {"red": (210, 40, 40), "blue": (40, 40, 210), "green": (40, 190, 60)}


def product_photo(color, rng, size=(160, 200), at=(40, 50)):
    a = np.full(size + (3,), 230, np.uint8)
    y, x = at
    a[y:y + 80, x:x + 100] = color
    return np.clip(a + rng.integers(0, 10, a.shape), 0, 255).astype(np.uint8)


def _numpy_params(jparams):
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in jparams.items()}


def test_propose_boxes_matches_jax():
    rng = np.random.default_rng(3)
    imgs = np.stack([product_photo(COLORS["red"], rng),
                     product_photo(COLORS["blue"], rng, at=(10, 90)),
                     np.full((160, 200, 3), 128, np.uint8)]).astype(np.float32)
    for kw in (dict(max_boxes=2), dict(max_boxes=4, pool=4)):
        jb, jc = jsal.propose_boxes(jnp.asarray(imgs), **kw)
        tb, tc = tsal.propose_boxes(torch.from_numpy(imgs), **kw)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


def test_propose_boxes_downsampled_serving_size_matches_jax():
    """At a 512 canvas the proposer works on a stride-3 pooled grid."""
    rng = np.random.default_rng(4)
    img = np.full((512, 512, 3), 220, np.uint8)
    img[100:300, 150:420] = COLORS["green"]
    img = np.clip(img + rng.integers(0, 10, img.shape), 0, 255)
    imgs = img[None].astype(np.float32)
    jb, jc = jsal.propose_boxes(jnp.asarray(imgs), max_boxes=4)
    tb, tc = tsal.propose_boxes(torch.from_numpy(imgs), max_boxes=4)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)


def test_crop_resize_batch_matches_jax():
    """Downscaling (antialiased, widened kernel), upscaling and an
    out-of-frame box: 1e-3 on the 0..255 scale (f32 sums in another
    order)."""
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 255, (3, 120, 150, 3)).astype(np.float32)
    boxes = np.array([[10.0, 5.0, 140.0, 110.0],
                      [30.5, 40.0, 50.0, 52.0],
                      [-20.0, 100.0, 160.0, 130.0]], np.float32)
    want = np.asarray(jcrop(jnp.asarray(imgs), jnp.asarray(boxes), out_size=32))
    got = tcrop(torch.from_numpy(imgs), torch.from_numpy(boxes), out_size=32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


@pytest.fixture(scope="module")
def both():
    """Tower weights, reference crops and delegates built by each package
    from the same numpy-seeded inputs."""
    jcfg = jm.CLIPVisionConfig(**CFG)
    jparams = jm.init_params(jcfg, seed=0)
    params = tm.params_from_jax(_numpy_params(jparams))
    rng = np.random.default_rng(0)
    crops, paths, classes = [], [], []
    for cls, col in COLORS.items():
        for i in range(5):
            # The object plus the 20% margin the serving crop adds.
            img = product_photo(col, rng)[24:136, 30:170]
            crops.append(np.asarray(Image.fromarray(img).resize((64, 64))))
            paths.append(f"/{cls}/{i}.png")
            classes.append(cls)
    batch = (np.stack(crops).astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    jg = JGallery("serve", dim=CFG["embed_dim"])
    jep.embed_arrays(jg, jep.make_encoder(jparams, jcfg), batch, paths,
                     classes, batch_size=8)
    jdp.build_delegates(jg)
    tg = TGallery("serve", dim=CFG["embed_dim"], device="cpu")
    tep.embed_arrays(tg, tep.make_encoder(params, tm.CLIPVisionConfig(**CFG),
                                          device="cpu"),
                     batch, paths, classes, batch_size=8)
    tdp.build_delegates(tg)
    return dict(jcfg=jcfg, jparams=jparams, jg=jg, params=params, tg=tg)


def test_embed_arrays_matches_jax(both):
    """Same ids and payloads; embeddings to 2e-4 (the f32 tower
    tolerance)."""
    jrecs = both["jg"].scroll_all(with_vectors=True)
    trecs = both["tg"].scroll_all(with_vectors=True)
    assert [r.id for r in trecs] == [r.id for r in jrecs]
    for t, j in zip(trecs, jrecs):
        assert t.payload.to_dict() == j.payload.to_dict()
        np.testing.assert_allclose(t.vector, j.vector, atol=2e-4)


def _delegates(g):
    from retrieval_based_object_detection_tpu_torch.gallery.schema import (
        Filter,
    )

    recs = g.scroll_all(Filter(must={"is_delegate": True,
                                     "delegate_type": "average"})
                        & Filter.for_case("pre_a"), with_vectors=True)
    return [r.payload.class_name for r in recs], np.stack(
        [r.vector for r in recs])


def test_detect_embed_classify_f32_matches_jax(both):
    """The port's f32 tower against the JAX path (whose encode is bf16):
    the same class for every box, similarity within 2e-2, the bf16
    rounding of a 2-layer tower."""
    rng = np.random.default_rng(42)
    imgs = np.stack([product_photo(COLORS[c], rng) for c in COLORS])
    names, dmat = _delegates(both["tg"])
    want = jsv.detect_embed_classify(both["jparams"], jnp.asarray(imgs),
                                     jnp.asarray(dmat), both["jcfg"])
    tower = tm.build_tower(both["params"], tm.CLIPVisionConfig(**CFG),
                           device="cpu")
    got = tsv.detect_embed_classify(tower, torch.from_numpy(imgs),
                                    torch.from_numpy(dmat))
    np.testing.assert_array_equal(got["boxes"].numpy(),
                                  np.asarray(want["boxes"]))
    np.testing.assert_array_equal(got["class_id"].numpy(),
                                  np.asarray(want["class_id"]))
    np.testing.assert_allclose(got["similarity"].numpy(),
                               np.asarray(want["similarity"]), atol=2e-2)
    assert [names[i] for i in got["class_id"][:, 0].tolist()] == list(COLORS)


def test_embed_classify_boxes_external_detector(both):
    rng = np.random.default_rng(11)
    red = product_photo(COLORS["red"], rng)
    _, dmat = _delegates(both["tg"])
    tower = tm.build_tower(both["params"], tm.CLIPVisionConfig(**CFG),
                           device="cpu")
    out = tsv.embed_classify_boxes(
        tower, torch.from_numpy(red[None]),
        torch.tensor([[50.0, 40.0, 150.0, 120.0]]), torch.from_numpy(dmat))
    # Margin applied: 100x80 box + 20% -> (30,24)-(170,136).
    assert out["boxes"][0].tolist() == [30.0, 24.0, 170.0, 136.0]


def _post(url, img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _serve(detector, requests):
    srv = detector[0](detector[1], host="127.0.0.1", port=0,
                      serving_size=256, max_batch=8, batch_wait_ms=200)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as ex:
            dets = list(ex.map(lambda im: _post(base + "/detect", im),
                               requests))
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    return dets, stats


def test_whole_slice_through_serve_http_matches_jax(both):
    """Five concurrent uploads per package: the micro-batcher batches
    them; class names equal the JAX run's, similarities agree within
    2e-2 (both serve in bf16, rounded at different places)."""
    rng = np.random.default_rng(7)
    reqs = [product_photo(COLORS[c], rng, size=(150 + 10 * i, 220))
            for i, c in enumerate(["red", "blue", "green", "blue", "red"])]
    jdet = jsv.RetrievalDetector(both["jparams"], both["jg"], both["jcfg"])
    tdet = tsv.RetrievalDetector(both["params"], both["tg"],
                                 tm.CLIPVisionConfig(**CFG), device="cpu")
    jout, _ = _serve((jsv.serve_http, jdet), reqs)
    tout, stats = _serve((tsv.serve_http, tdet), reqs)
    assert [d["class_name"] for d in tout] == \
        ["red", "blue", "green", "blue", "red"]
    assert [d["class_name"] for d in tout] == [d["class_name"] for d in jout]
    for t, j in zip(tout, jout):
        assert abs(t["similarity"] - j["similarity"]) < 2e-2
        np.testing.assert_allclose(t["box"], j["box"], atol=1e-3)
        assert len(t["detections"]) == len(j["detections"])
    assert stats["requests"] == 5 and stats["errors"] == 0
    assert max(int(k) for k in stats["batch_sizes"]) >= 2, stats


def test_detector_reload_and_missing_delegates(both):
    g = TGallery("empty", dim=CFG["embed_dim"], device="cpu")
    with pytest.raises(ValueError, match="no delegates"):
        tsv.RetrievalDetector(both["params"], g, tm.CLIPVisionConfig(**CFG),
                              device="cpu")
    det = tsv.RetrievalDetector(both["params"], both["tg"],
                                tm.CLIPVisionConfig(**CFG), device="cpu")
    assert det.reload_delegates() == 3
    assert sorted(det.classes) == sorted(COLORS)


class _CountingDetector:
    """Stands in for RetrievalDetector: records batch sizes and tags each
    image with a value from its contents, so result routing is
    checkable."""

    device = torch.device("cpu")

    def __init__(self):
        self.batches = []

    def detect(self, images):
        self.batches.append(images.shape[0])
        return [{"similarity": float(images[i, 0, 0, 0]) / 255.0}
                for i in range(images.shape[0])]


def test_microbatcher_batches_concurrent_and_routes_results():
    det = _CountingDetector()
    mb = tsv.MicroBatcher(det, max_batch=8, max_wait_ms=120)
    values = (10, 20, 30, 40, 50)
    with concurrent.futures.ThreadPoolExecutor(len(values)) as ex:
        results = list(ex.map(
            lambda v: mb.submit(np.full((8, 8, 3), v, np.uint8)), values))
    for v, r in zip(values, results):
        assert r["similarity"] == pytest.approx(v / 255.0)
    assert max(det.batches) >= 2, det.batches
    assert set(det.batches) <= set(mb.sizes)


def test_http_reload_errors_and_unbatched_path(both):
    """``max_batch=1`` serves without the micro-batcher; ``POST /reload``
    reports the class count; a bad body is a 400 and an unknown path a
    404."""
    det = tsv.RetrievalDetector(both["params"], both["tg"],
                                tm.CLIPVisionConfig(**CFG), device="cpu")
    srv = tsv.serve_http(det, host="127.0.0.1", port=0, serving_size=256,
                         max_batch=1)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def status(path, data=None):
        req = urllib.request.Request(base + path, data=data,
                                     method="POST" if data else "GET")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        rng = np.random.default_rng(9)
        assert _post(base + "/detect", product_photo(
            COLORS["green"], rng))["class_name"] == "green"
        assert status("/reload", b"{}") == (200, {"classes": 3})
        assert status("/detect", b"not an image")[0] == 400
        assert status("/nope")[0] == 404
        code, stats = status("/stats")
        assert code == 200 and stats["requests"] == 1
        assert "batch_sizes" not in stats
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
