"""The plain references against the port's plain paths, at tiny sizes on
the CPU: the CLIP tower, the letterbox, the saliency proposals, the
crop, the delegates and the exact filtered top-k, the crop preprocess;
and the control's products are coarser than the reference's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchcore import images as imgs
from benchcore import spec
from benchcore.port import clip_config
from benchcore.weights import clip_state
from reference import clip, detect, embed, search

TINY = {**spec.config("clip-vit-b32"), "width": 64, "layers": 2,
        "heads": 2, "embed_dim": 32, "image_size": 64, "patch_size": 16}


def photo(seed, h=120, w=160):
    return imgs.product_photo(imgs.rng_for(seed, 0, 0),
                              imgs.class_color(seed % 7), h, w)


def test_clip_tower_matches_the_port_in_f32():
    from retrieval_based_object_detection_tpu_torch.models.clip import model

    state = clip_state(torch, TINY, 5, "cpu")
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    tower = model.build_tower(state, clip_config(TINY), dtype=torch.float32,
                              device="cpu")
    want = model.encode_image(tower, x)
    got = clip.encode_blocks(state, TINY, x, block=2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_letterbox_matches_the_port():
    from retrieval_based_object_detection_tpu_torch.pipelines.labeling import (
        letterbox,
    )

    img = photo(3)
    got, gs = detect.letterbox(img, 128)
    want, ws = letterbox(img, 128)
    assert gs == ws and np.array_equal(got, want)


@pytest.mark.parametrize("size", [128, 512])
def test_proposals_and_crops_match_the_port(size):
    from retrieval_based_object_detection_tpu_torch.models.detector import (
        saliency,
    )
    from retrieval_based_object_detection_tpu_torch.ops.image import (
        crop_resize_batch,
    )

    x = torch.as_tensor(np.stack([detect.letterbox(photo(s), size)[0]
                                  for s in range(3)])).float()
    boxes, conf = detect.propose(x, 4)
    want_b, want_c = saliency.propose_boxes(x, max_boxes=4)
    assert torch.equal(boxes, want_b) and torch.equal(conf, want_c)
    ex = detect.margin(boxes, size, size)
    got = detect.crop_resize(x, ex[:, 0], 64)
    torch.testing.assert_close(got, crop_resize_batch(x, ex[:, 0], 64),
                               rtol=1e-5, atol=1e-3)


def test_detection_answers_match_the_port_in_f32():
    """The reference's class cosines against ``detect_embed_classify``
    with an f32 tower and the same delegates."""
    from retrieval_based_object_detection_tpu_torch.models.clip import model
    from retrieval_based_object_detection_tpu_torch.pipelines import serve

    state = clip_state(torch, TINY, 9, "cpu")
    tower = model.build_tower(state, clip_config(TINY), dtype=torch.float32,
                              device="cpu")
    dmat = torch.randn(5, TINY["embed_dim"],
                       generator=torch.Generator().manual_seed(2))
    uploads = [imgs.jpeg(photo(s), 90) for s in range(2)]
    ans = detect.answers(uploads, state, TINY, dmat, 128, 4, "cpu")
    canv = torch.as_tensor(np.stack([
        detect.letterbox(detect.decode(u), 128)[0] for u in uploads]))
    out = serve.detect_embed_classify(tower, canv, dmat, max_boxes=4)
    for i, a in enumerate(ans):
        np.testing.assert_allclose(a["sims"], out["all_sims"][i].numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a["conf"], out["confidence"][i].numpy())


def test_delegates_are_class_means_of_the_tower():
    state = clip_state(torch, TINY, 4, "cpu")
    x = torch.randn(6, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    d = detect.delegates(state, TINY, x, [0, 0, 1, 1, 1, 2], 3)
    emb = clip.encode_blocks(state, TINY, x)
    torch.testing.assert_close(d[1], emb[2:5].mean(0))


def test_exact_topk_matches_the_port_gallery():
    from retrieval_based_object_detection_tpu_torch.gallery.schema import (
        Filter,
        Payload,
    )
    from retrieval_based_object_detection_tpu_torch.gallery.store import (
        Gallery,
    )

    g = torch.Generator().manual_seed(0)
    rows = torch.randn(500, 32, generator=g)
    cls = torch.randint(0, 3, (500,), generator=g)
    gal = Gallery("t", dim=32, capacity=512, device="cpu")
    gal.upsert([f"r{i}" for i in range(500)], rows.numpy(),
               [Payload(data_type="original_images",
                        class_name=f"c{int(c)}") for c in cls])
    q = rows[:4] + 0.5 * torch.randn(4, 32, generator=g)
    hits = gal.search(q.numpy(), k=10, flt=Filter(must={"class_name": "c1"}))
    scores, idx = search.topk(rows, q, cls == 1, 10)
    for h, s, i in zip(hits, scores, idx):
        assert [x.id for x in h] == [f"r{int(j)}" for j in i]
        np.testing.assert_allclose([x.score for x in h], s.numpy(),
                                   rtol=1e-5, atol=1e-6)
    again = search.scores_of(rows, q, idx)
    torch.testing.assert_close(again, scores)


def test_crop_preprocess_matches_the_port(tmp_path):
    from retrieval_based_object_detection_tpu_torch.models.clip import (
        preprocess,
    )

    path = tmp_path / "c.jpg"
    path.write_bytes(imgs.jpeg(photo(2, 300, 170), 90))
    want = preprocess.load_and_preprocess(str(path))
    assert np.array_equal(embed.preprocess(str(path)), want)


def test_the_controls_products_are_coarser():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 256, generator=g), torch.randn(256, 64,
                                                          generator=g)
    exact = (a.double() @ b.double()).float()
    err = {f.__name__: ((f(a, b) - exact).abs().max() / exact.abs().max())
           for f in (clip.f32_mm, clip.tf32_mm, clip.fp8_mm)}
    assert err["f32_mm"] < 1e-6
    assert 1e-5 < err["tf32_mm"] < 1e-2
    assert err["fp8_mm"] > 3 * err["tf32_mm"]
