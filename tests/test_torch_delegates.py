"""Port parity: delegate strategies and the delegate build stage."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery.store import Gallery as JGallery
from retrieval_based_object_detection_tpu.models.clip.model import (
    CLIPVisionConfig,
    init_params,
)
from retrieval_based_object_detection_tpu.ops import delegates as jd
from retrieval_based_object_detection_tpu.pipelines import delegates as jdp
from retrieval_based_object_detection_tpu.pipelines import embed as jep
from retrieval_based_object_detection_tpu_torch.gallery import schema as tschema
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
)
from retrieval_based_object_detection_tpu_torch.ops import delegates as td
from retrieval_based_object_detection_tpu_torch.pipelines import delegates as tdp

TINY = CLIPVisionConfig(image_size=64, patch_size=16, width=64, layers=2,
                        heads=1, embed_dim=32)


@pytest.mark.parametrize("n,valid", [(1, 1), (7, 7), (64, 37), (200, 150)])
def test_compute_all_delegates_matches_jax(n, valid):
    """All four strategies to 1e-5 with a padded, masked member matrix."""
    rng = np.random.default_rng(n)
    vecs = rng.normal(size=(n, 16)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[:valid] = True
    want = jd.compute_all_delegates(jnp.asarray(vecs), jnp.asarray(mask))
    got = td.compute_all_delegates(torch.from_numpy(vecs),
                                   torch.from_numpy(mask))
    partial = td.compute_partial_delegates(torch.from_numpy(vecs),
                                           torch.from_numpy(mask))
    for k in td.DELEGATE_TYPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
        if k != "medoid":
            np.testing.assert_array_equal(partial[k].numpy(), got[k].numpy())


def _write_images(root, img_type, cls, n, color, seed):
    d = root / f"{img_type}_images" / cls
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        arr = np.zeros((80, 70, 3), np.uint8)
        arr[..., :] = color
        arr += rng.integers(0, 40, arr.shape, dtype=np.uint8)
        Image.fromarray(arr).save(d / f"img_{i}.png")


@pytest.fixture(scope="module")
def e2e_gallery(tmp_path_factory):
    """The tree of tests/test_e2e_slice.py, embedded by the JAX package."""
    base = tmp_path_factory.mktemp("data")
    colors = {"classA": (200, 30, 30), "classB": (30, 30, 200)}
    for s, stage in enumerate(("dataset_cropped", "dataset_segmented")):
        for c, cls in enumerate(colors):
            _write_images(base / stage, "original", cls, 4, colors[cls],
                          seed=10 * s + c)
            _write_images(base / stage, "natural", cls, 3, colors[cls],
                          seed=10 * s + c + 5)
    gallery = JGallery("e2e", dim=TINY.embed_dim)
    encoder = jep.make_encoder(init_params(TINY, seed=1), TINY)
    for stage in ("dataset_cropped", "dataset_segmented"):
        for img_type in ("original", "natural"):
            jep.embed_tree(gallery, encoder, jep.EmbedConfig(
                root_dir=str(base / stage), img_type=img_type,
                image_size=TINY.image_size, batch_size=8))
    return gallery


def test_build_delegates_on_e2e_tree_matches_jax(e2e_gallery):
    """The same points in both stores → the same 32 delegates (ids,
    payloads, vectors to 1e-5) and the same member counts."""
    tg = TGallery("e2e", dim=TINY.embed_dim, device="cpu")
    recs = e2e_gallery.scroll_all(with_vectors=True)
    tg.upsert([r.id for r in recs], np.stack([r.vector for r in recs]),
              [tschema.Payload(**r.payload.to_dict()) for r in recs])
    jres = jdp.build_delegates(e2e_gallery)
    tres = tdp.build_delegates(tg)
    assert tres.n_delegates_written == jres.n_delegates_written == 32
    assert tres.member_counts == jres.member_counts
    assert tres.member_counts[("classA", "pre_a", "natural_images")] == 3
    assert tdp.list_classes(tg) == ["classA", "classB"]
    flt = tschema.Filter(must={"is_delegate": True})
    tdel = {r.id: r for r in tg.scroll_all(flt, with_vectors=True)}
    jdel = {r.id: r for r in e2e_gallery.scroll_all(
        jschema.Filter(must={"is_delegate": True}), with_vectors=True)}
    assert tdel.keys() == jdel.keys() and len(tdel) == 32
    for pid, r in tdel.items():
        assert r.payload.to_dict() == jdel[pid].payload.to_dict()
        np.testing.assert_allclose(r.vector, jdel[pid].vector, atol=1e-5)
    # Idempotent: deterministic ids overwrite rather than duplicate.
    tdp.build_delegates(tg)
    assert tg.count(flt) == 32


def test_large_class_raises_until_the_medoid_kernel_is_ported(monkeypatch):
    """The blocked medoid kernel (B4) is ported: a class above the
    threshold no longer raises, and its delegates equal the dense path's."""
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(5, 4)).astype(np.float32)
    pls = [tschema.Payload(data_type="original_images", class_name="x")
           for _ in range(5)]
    dense = TGallery("dense", dim=4, device="cpu")
    big = TGallery("big", dim=4, device="cpu")
    for g in (dense, big):
        g.upsert([f"p{i}" for i in range(5)], vecs, pls)
    tdp.build_delegates(dense)
    monkeypatch.setattr(tdp, "LARGE_CLASS_THRESHOLD", 4)
    assert tdp.build_delegates(big).n_delegates_written == 4
    flt = tschema.Filter(must={"is_delegate": True})
    for a, b in zip(dense.scroll_all(flt, True), big.scroll_all(flt, True)):
        assert a.id == b.id
        np.testing.assert_allclose(a.vector, b.vector, atol=1e-6)
