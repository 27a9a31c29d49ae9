"""Port parity: the offline experiment path — embed_tree → gallery →
build_delegates → run_experiments → CSV/npy — against the JAX package.

A twin of tests/test_e2e_slice.py: the same TINY CLIP config, the same kind
of tree, and the same weights (the JAX ``init_params(TINY, seed=1)``
carried across by ``params_from_jax``). Tolerances: embeddings and
delegates 2e-4 (the CLIP f32 parity tolerance of
tests/test_torch_clip_model.py), experiment scores 1e-5 (cosines of vectors
that agree to 2e-4, in f32); everything else — point ids, payloads, row
order, predictions, file names — is equal.
"""

import csv
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from retrieval_based_object_detection_tpu.gallery import schema as jschema
from retrieval_based_object_detection_tpu.gallery.store import Gallery as JGallery
from retrieval_based_object_detection_tpu.models.clip import model as jclip
from retrieval_based_object_detection_tpu.pipelines import delegates as jdp
from retrieval_based_object_detection_tpu.pipelines import embed as jep
from retrieval_based_object_detection_tpu.pipelines import experiments as jxp
from retrieval_based_object_detection_tpu_torch.gallery import schema as tschema
from retrieval_based_object_detection_tpu_torch.gallery.store import (
    Gallery as TGallery,
)
from retrieval_based_object_detection_tpu_torch.models.clip import (
    model as tclip,
)
from retrieval_based_object_detection_tpu_torch.models.clip import (
    preprocess as tpp,
)
from retrieval_based_object_detection_tpu_torch.ops import medoid as tm
from retrieval_based_object_detection_tpu_torch.pipelines import (
    delegates as tdp,
)
from retrieval_based_object_detection_tpu_torch.pipelines import embed as tep
from retrieval_based_object_detection_tpu_torch.pipelines import (
    experiments as txp,
)
from retrieval_based_object_detection_tpu_torch.utils import loader, tree

TINY = dict(image_size=64, patch_size=16, width=64, layers=2, heads=1,
            embed_dim=32)
CLASSES = ["classA", "classB"]
STAGES = ("dataset_cropped", "dataset_segmented")
HEADER = ["experiment_id", "case", "delegate_type", "image_path",
          "true_class", "predicted_class", "similarity_score"]


def _write_images(root: Path, img_type, cls, n, color, seed, mode="RGB"):
    d = root / f"{img_type}_images" / cls
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        arr = np.zeros((80, 70, 3), np.uint8)
        arr[..., :] = color
        arr += rng.integers(0, 40, arr.shape, dtype=np.uint8)
        img = Image.fromarray(arr)
        if mode == "RGBA":  # segmented crops carry an alpha channel
            img.putalpha(200)
        img.save(d / f"img_{i}.png")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    colors = {"classA": (200, 30, 30), "classB": (30, 30, 200)}
    for s, stage in enumerate(STAGES):
        mode = "RGBA" if stage == "dataset_segmented" else "RGB"
        for c, cls in enumerate(CLASSES):
            _write_images(base / stage, "original", cls, 4, colors[cls],
                          seed=10 * s + c, mode=mode)
            _write_images(base / stage, "natural", cls, 3, colors[cls],
                          seed=10 * s + c + 5, mode=mode)
    (base / "dataset_cropped" / "natural_images" / "classA" /
     "broken.png").write_bytes(b"not a png")
    return base


def _numpy_params(jparams):
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in jparams.items()}


class _Log:
    def __init__(self):
        self.calls = []

    def summary(self, **kw):
        self.calls.append(kw)


@pytest.fixture(scope="module")
def galleries(dataset):
    jcfg = jclip.CLIPVisionConfig(**TINY)
    jparams = jclip.init_params(jcfg, seed=1)
    jenc = jep.make_encoder(jparams, jcfg)
    tenc = tep.make_encoder(tclip.params_from_jax(_numpy_params(jparams)),
                            tclip.CLIPVisionConfig(**TINY), device="cpu")
    jg = JGallery("e2e", dim=TINY["embed_dim"])
    tg = TGallery("e2e", dim=TINY["embed_dim"], device="cpu")
    counts, log = {}, _Log()
    for stage in STAGES:
        for img_type in ("original", "natural"):
            kw = dict(root_dir=str(dataset / stage), img_type=img_type,
                      image_size=TINY["image_size"], batch_size=3)
            jres = jep.embed_tree(jg, jenc, jep.EmbedConfig(**kw))
            tres = tep.embed_tree(tg, tenc, tep.EmbedConfig(**kw), logger=log)
            counts[(stage, img_type)] = (jres, tres)
    return jg, tg, counts, log


def test_embed_tree_points_match_jax(galleries):
    jg, tg, counts, log = galleries
    assert len(tg) == len(jg) == 28
    for jres, tres in counts.values():
        assert tres.per_class_counts == jres.per_class_counts
        assert tres.n_failed == jres.n_failed
    assert counts[("dataset_cropped", "natural")][1].n_failed == 1
    assert counts[("dataset_segmented", "original")][1].total == 8
    trecs = tg.scroll_all(with_vectors=True)
    jrecs = jg.scroll_all(with_vectors=True)
    assert [r.id for r in trecs] == [r.id for r in jrecs]
    for t, j in zip(trecs, jrecs):
        assert t.payload.to_dict() == j.payload.to_dict()
        np.testing.assert_allclose(t.vector, j.vector, atol=2e-4, rtol=0)
    assert tg.count(tschema.Filter(must={"is_segmented": True})) == 14
    assert len(log.calls) == 4 and log.calls[0]["total"] == 8
    assert log.calls[0]["crops_per_sec"] > 0


def test_tree_walk_and_preprocess_match_jax(dataset):
    from retrieval_based_object_detection_tpu.models.clip import (
        preprocess as jpp,
    )
    from retrieval_based_object_detection_tpu.utils import tree as jtree

    root = dataset / "dataset_segmented"
    assert tree.walk(root, "natural") == [
        tree.ImageEntry(e.path, e.class_name, e.img_type)
        for e in jtree.walk(root, "natural")]
    assert tree.stage_flags(root) == jtree.stage_flags(root)
    assert tree.list_classes(root, "original") == CLASSES
    path = tree.list_images(root, "original", "classB")[2]
    np.testing.assert_array_equal(tpp.load_and_preprocess(path, 64),
                                  jpp.load_and_preprocess(path, 64))
    assert tpp.load_and_preprocess(dataset / "dataset_cropped" /
                                   "natural_images" / "classA" /
                                   "broken.png") is None


def test_loader_prefetches_in_order_and_surfaces_errors():
    out = list(loader.PrefetchIterator(loader.batched(list(range(7)), 3),
                                       lambda b: sum(b)))
    assert out == [3, 12, 6]
    assert loader.parallel_map(lambda x: x * x, list(range(20)),
                               workers=4) == [x * x for x in range(20)]

    def boom(_):
        raise KeyError("decode")

    it = loader.PrefetchIterator([1], boom)
    with pytest.raises(KeyError):
        next(it)


@pytest.fixture(scope="module")
def with_delegates(galleries):
    jg, tg, _, _ = galleries
    return jg, tg, jdp.build_delegates(jg), tdp.build_delegates(tg)


def test_delegates_match_jax(with_delegates):
    jg, tg, jres, tres = with_delegates
    assert tres.n_delegates_written == jres.n_delegates_written == 32
    assert tres.member_counts == jres.member_counts
    tdel = {r.id: r for r in tg.scroll_all(
        tschema.Filter(must={"is_delegate": True}), with_vectors=True)}
    jdel = {r.id: r for r in jg.scroll_all(
        jschema.Filter(must={"is_delegate": True}), with_vectors=True)}
    assert tdel.keys() == jdel.keys() and len(tdel) == 32
    for pid, r in tdel.items():
        assert r.payload.to_dict() == jdel[pid].payload.to_dict()
        np.testing.assert_allclose(r.vector, jdel[pid].vector, atol=2e-4,
                                   rtol=0)


def _rows(out):
    return [(r.experiment_id, r.case, r.delegate_type, r.image_path,
             r.true_class, r.predicted_class) for r in out.rows]


@pytest.mark.parametrize("mode", ["same_class", "nearest"])
def test_experiment_rows_and_outputs_match_jax(with_delegates, dataset,
                                               tmp_path, mode):
    jg, tg, _, _ = with_delegates
    kw = dict(root_dir=str(dataset / "dataset_segmented"), match_mode=mode)
    jout = jxp.run_experiments(
        jg, jxp.ExperimentConfig(results_dir=str(tmp_path / "j"), **kw))
    tout = txp.run_experiments(
        tg, txp.ExperimentConfig(results_dir=str(tmp_path / "t"), **kw))
    # 6 natural test images x 2 cases with delegates x 4 dtypes.
    assert len(tout.rows) == 48
    assert _rows(tout) == _rows(jout)
    np.testing.assert_allclose([r.similarity_score for r in tout.rows],
                               [r.similarity_score for r in jout.rows],
                               atol=1e-5, rtol=0)
    assert tout.class_image_count == jout.class_image_count == {
        "classA": 9, "classB": 9}
    if mode == "same_class":
        assert all(r.predicted_class == r.true_class for r in tout.rows)
    assert tout.scores.keys() == jout.scores.keys()

    # Layout: results/<date>-<n>/result_<date>-<n>.csv + score_distribution.
    stem = tout.csv_path.parent.name
    assert tout.csv_path.name == f"result_{stem}.csv"
    assert tout.csv_path.parent.parent == tmp_path / "t"
    assert jout.csv_path.parent.name == stem
    with open(tout.csv_path) as f:
        trows = list(csv.reader(f))
    with open(jout.csv_path) as f:
        jrows = list(csv.reader(f))
    assert trows[0] == jrows[0] == HEADER
    assert [r[:6] for r in trows] == [r[:6] for r in jrows]
    names = sorted(p.name for p in (tout.csv_path.parent /
                                    "score_distribution").glob("*.npy"))
    assert names == sorted(p.name for p in (
        jout.csv_path.parent / "score_distribution").glob("*.npy"))
    assert len(names) == 8 and "pre_b_medoid_scores.npy" in names
    np.testing.assert_allclose(
        np.load(tout.csv_path.parent / "score_distribution" / names[0]),
        np.load(jout.csv_path.parent / "score_distribution" / names[0]),
        atol=1e-5, rtol=0)


def test_collision_free_result_dirs(tmp_path):
    d1, c1 = txp.allocate_result_dir(tmp_path, today="2026-01-01")
    c1.touch()
    d2, c2 = txp.allocate_result_dir(tmp_path, today="2026-01-01")
    assert d1.name == "2026-01-01-1" and d2.name == "2026-01-01-2"
    assert c2.name == "result_2026-01-01-2.csv"


def test_get_by_path_relative_and_absolute(galleries, dataset, monkeypatch):
    """Relative, ``./``-prefixed and absolute spellings of one file find
    the same point in both packages; retrieve returns it by id."""
    jg, tg, _, _ = galleries
    img = tree.list_images(dataset / "dataset_cropped", "natural",
                           "classB")[1]
    monkeypatch.chdir(dataset)
    rel = os.path.relpath(img, dataset)
    for spelling in (str(img), rel, "./" + rel,
                     str(dataset / "dataset_cropped" / ".." /
                         "dataset_cropped" / rel.split(os.sep, 1)[1])):
        t, j = tg.get_by_path(spelling), jg.get_by_path(spelling)
        assert t is not None and j is not None, spelling
        assert t.id == j.id and t.payload.to_dict() == j.payload.to_dict()
        np.testing.assert_array_equal(t.vector, tg.retrieve([t.id])[0].vector)
    assert tg.get_by_path("nowhere/x.png") is None
    assert jg.get_by_path("nowhere/x.png") is None
    assert [r.id for r in tg.retrieve(["missing", t.id], with_vectors=False)
            ] == [t.id]


def test_resolved_index_follows_overwrites_like_jax():
    """Two ids share one resolved path; overwriting the first's path
    promotes the second in both packages."""
    gs = ((jschema, JGallery("p", dim=4)),
          (tschema, TGallery("p", dim=4, device="cpu")))
    for mod, g in gs:
        def pl(path):
            return mod.Payload(data_type="original_images", class_name="x",
                               img_path=path)
        g.upsert(["a", "b"], np.eye(4, dtype=np.float32)[:2],
                 [pl("/d/./x.png"), pl("/d/x.png")])
        assert g.get_by_path("/d//x.png").id == "a"
        g.upsert(["a"], np.eye(4, dtype=np.float32)[2:3], [pl("/e/y.png")])
    (_, jg), (_, tg) = gs
    for p in ("/d//x.png", "/e/../e/y.png", "/d/./x.png"):
        assert tg.get_by_path(p).id == jg.get_by_path(p).id


def test_large_class_branch_matches_jax(monkeypatch):
    """With the threshold lowered in both packages, a 300-member class
    takes the blocked-medoid branch: the same four delegates as the JAX
    package's branch, and the medoid equal to the dense one."""
    monkeypatch.setattr(jdp, "LARGE_CLASS_THRESHOLD", 128)
    monkeypatch.setattr(tdp, "LARGE_CLASS_THRESHOLD", 128)
    launches = tm.KERNEL.launches
    calls = []

    def spy(members):
        calls.append(len(members))
        return tm.pairwise_distance_sums(members)

    monkeypatch.setattr(tdp, "pairwise_distance_sums", spy)
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(300, 16)).astype(np.float32)
    small = rng.normal(size=(20, 16)).astype(np.float32)
    jg, tg = JGallery("big", dim=16), TGallery("big", dim=16, device="cpu")
    for mod, g in ((jschema, jg), (tschema, tg)):
        g.upsert([f"p{i}" for i in range(300)], vecs,
                 [mod.Payload(data_type="original_images", class_name="big",
                              img_path=f"/big/{i}.png") for i in range(300)])
        g.upsert([f"s{i}" for i in range(20)], small,
                 [mod.Payload(data_type="original_images",
                              class_name="small", img_path=f"/s/{i}.png")
                  for i in range(20)])
    jres, tres = jdp.build_delegates(jg), tdp.build_delegates(tg)
    assert tres.member_counts == jres.member_counts
    assert tres.member_counts[("big", "pre_a", "original_images")] == 300
    assert tres.n_delegates_written == jres.n_delegates_written == 8
    assert calls == [300]  # only the large group took the blocked medoid
    flt = dict(must={"is_delegate": True, "class_name": "big"})
    tdel = {r.payload.delegate_type: r.vector
            for r in tg.scroll_all(tschema.Filter(**flt), with_vectors=True)}
    jdel = {r.payload.delegate_type: r.vector
            for r in jg.scroll_all(jschema.Filter(**flt), with_vectors=True)}
    assert tdel.keys() == jdel.keys() == {"average", "centroid", "weighted",
                                          "medoid"}
    for k in tdel:
        np.testing.assert_allclose(tdel[k], jdel[k], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tdel["medoid"], jdel["medoid"])
    np.testing.assert_array_equal(tdel["medoid"],
                                  tm.medoid_large(vecs, device="cpu"))
    assert tm.KERNEL.launches == launches  # CPU tensors: the plain version


def test_experiment_config_defaults_match_jax():
    t = dataclasses.asdict(txp.ExperimentConfig(root_dir="r"))
    j = dataclasses.asdict(jxp.ExperimentConfig(root_dir="r"))
    assert t == j
    assert txp.TEST_GROUPS == jxp.TEST_GROUPS
