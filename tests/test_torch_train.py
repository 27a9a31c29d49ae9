"""Port parity: CLIP fine-tuning (train step, optimizer, fit loop and
checkpoints) against the JAX package.

The same numpy-seeded weights and images go through both packages on the
CPU. Where the stacks differ by construction the comparison is made where
it is meaningful: AdamW's first step moves every parameter by ±lr
(m̂/√v̂ = ±1), so a gradient near 0 may flip sign between two correct
implementations; parameters after whole steps are therefore not compared
elementwise. Gradients of one step are, and the optimizer alone is fed
identical gradients in both packages.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from retrieval_based_object_detection_tpu.models.clip import model as jm
from retrieval_based_object_detection_tpu.parallel.mesh import make_mesh
from retrieval_based_object_detection_tpu.train import loop as JL
from retrieval_based_object_detection_tpu.train import train as JT
from retrieval_based_object_detection_tpu_torch.models.clip import model as tm
from retrieval_based_object_detection_tpu_torch.train import loop as TL
from retrieval_based_object_detection_tpu_torch.train import train as T
from retrieval_based_object_detection_tpu_torch.utils import checkpoint as C

# tests/test_train_loop.py's tower, and one with several heads and layers.
TINY = dict(image_size=32, patch_size=16, width=64, layers=1, heads=1,
            embed_dim=16)
MULTI = dict(image_size=64, patch_size=16, width=64, layers=2, heads=4,
             embed_dim=32)
# The JAX package's tolerance for tower gradients
# (tests/test_clip_fused_attention.py).
GRAD_TOL = dict(atol=5e-3, rtol=1e-3)


def _tower_grads_like_jax(tower) -> dict:
    """The port tower's gradients in the JAX layout ([L, ...] blocks)."""
    out = {k: getattr(tower, k).grad.numpy() for k in tm._TOP_KEYS}
    out["blocks"] = {k: np.stack([getattr(b, k).grad.numpy()
                                  for b in tower.blocks])
                     for k in tm._BLOCK_KEYS}
    return out


def _assert_trees_close(got, want, **tol):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_close(got[k], v, **tol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(v), err_msg=k,
                                       **tol)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_tower_gradients_match_jax(remat):
    """Gradients of Σ emb² through the port tower (the attention core's
    backward is the autograd Function) against ``jax.grad`` of the JAX
    tower's einsum path, f32."""
    jcfg = jm.CLIPVisionConfig(**MULTI)
    jparams = jm.init_params(jcfg, seed=0)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)
                                        ).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jm.encode_image(
        p, jnp.asarray(x), jcfg, fused_attention=False) ** 2))(jparams)
    tower = tm.CLIPVisionTower(tm.CLIPVisionConfig(**MULTI), remat=remat)
    tower.load_state_dict(tm.params_from_jax(jax.tree.map(np.asarray,
                                                          jparams)))
    (tower(torch.from_numpy(x)) ** 2).sum().backward()
    _assert_trees_close(_tower_grads_like_jax(tower), want, **GRAD_TOL)


@pytest.mark.parametrize("head", ["linear", "cosine"])
def test_one_step_loss_accuracy_and_gradients_match_jax(head):
    cfg = dict(num_classes=3, compute_dtype="float32", head=head)
    jcfg = jm.CLIPVisionConfig(**TINY)
    jparams, _ = JT.init_state(jcfg, JT.TrainConfig(**cfg), seed=2)
    rng = np.random.default_rng(3)
    images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 3, size=8).astype(np.int32)
    (want_loss, want_acc), want_g = jax.value_and_grad(
        JT.loss_fn, has_aux=True)(jparams, images, labels, jcfg,
                                  JT.TrainConfig(**cfg))

    model, _ = T.init_state(tm.CLIPVisionConfig(**TINY), T.TrainConfig(**cfg),
                            seed=2, device="cpu")
    np.testing.assert_array_equal(model.head["w"].detach().numpy(),
                                  np.asarray(jparams["head"]["w"]))
    loss, acc = T.loss_fn(model, torch.from_numpy(images),
                          torch.from_numpy(labels).long(),
                          T.TrainConfig(**cfg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert float(acc) == float(want_acc)
    _assert_trees_close(_tower_grads_like_jax(model.tower),
                        want_g["tower"], **GRAD_TOL)
    # The cosine head does not use b: no gradient here, zeros in JAX.
    _assert_trees_close({k: v.grad.numpy() if v.grad is not None
                         else np.zeros(v.shape, np.float32)
                         for k, v in model.head.items()},
                        want_g["head"], **GRAD_TOL)


def test_train_step_bf16_updates_f32_master_weights():
    cfg = T.TrainConfig(num_classes=3, compute_dtype="bfloat16", remat=True)
    model, opt = T.init_state(tm.CLIPVisionConfig(**TINY), cfg, seed=2,
                              device="cpu")
    before = model.tower.blocks[0].w_qkv.detach().clone()
    rng = np.random.default_rng(4)
    metrics = T.make_train_step(cfg)(
        model, opt, rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
        rng.integers(0, 3, size=8))
    assert np.isfinite(float(metrics["loss"]))
    after = model.tower.blocks[0].w_qkv
    assert after.dtype == torch.float32 and not torch.equal(after, before)
    assert opt.count == 1


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_optimizer_matches_optax(schedule):
    """AdamW with weight decay under both schedules, fed the same gradient
    trees for 25 steps in both packages: the same f32 update formed in
    another order, one ulp or so per step, to 1e-6 absolute and relative."""
    cfg = dict(num_classes=2, learning_rate=1e-2, weight_decay=0.05,
               lr_schedule=schedule, total_steps=25)
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tx = JT.make_optimizer(JT.TrainConfig(**cfg))
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = T.make_optimizer(T.TrainConfig(**cfg), tp.values())
    for step in range(25):
        grads = {k: (rng.normal(size=s) * 10.0 ** -(step % 4)
                     ).astype(np.float32) for k, s in shapes.items()}
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state,
                                   jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6,
                                       rtol=1e-6,
                                       err_msg=f"{k} after step {step}")
    assert opt.count == 25


def test_schedule_matches_optax():
    for total in (2, 7, 25, 3000):
        cfg = dict(num_classes=2, learning_rate=3e-4, lr_schedule="cosine",
                   total_steps=total)
        warmup = min(max(total // 10, 1), 100)
        want = optax.warmup_cosine_decay_schedule(
            0.0, 3e-4, warmup, total, 3e-6)
        got = T.make_schedule(T.TrainConfig(**cfg))
        assert got(0) == 0.0  # the first step of a warmup has lr 0
        counts = set(range(min(total, 120) + 5)) | \
            set(range(0, total + 5, 37)) | {total - 1, total, total + 1}
        for count in sorted(counts):
            # optax evaluates in f32, the port in f64.
            np.testing.assert_allclose(got(count), float(want(count)),
                                       rtol=1e-5, atol=1e-12)


def test_schedule_needs_a_horizon():
    params = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="total_steps"):
        T.make_optimizer(T.TrainConfig(num_classes=2, lr_schedule="cosine"),
                         params)
    with pytest.raises(ValueError, match="lr_schedule"):
        T.make_optimizer(T.TrainConfig(num_classes=2, lr_schedule="linear"),
                         params)


@pytest.fixture
def crop_tree(tmp_path):
    """tests/test_train_loop.py's tree: two colour classes of 8 images."""
    rng = np.random.default_rng(0)
    for cls, col in (("a", (200, 30, 30)), ("b", (30, 30, 200))):
        d = tmp_path / "original_images" / cls
        d.mkdir(parents=True)
        for i in range(8):
            arr = np.full((40, 40, 3), col, np.uint8)
            arr += rng.integers(0, 30, arr.shape, dtype=np.uint8)
            Image.fromarray(arr).save(d / f"x{i}.png")
    return tmp_path


def _events(path, name):
    return [r for r in map(json.loads, path.read_text().splitlines())
            if r["event"] == name]


def test_fit_learns_checkpoints_and_resumes(crop_tree, tmp_path):
    ckpt, log = tmp_path / "ckpt", tmp_path / "log.jsonl"
    cfg = TL.FitConfig(root_dir=str(crop_tree), epochs=3, batch_size=8,
                       learning_rate=3e-3, compute_dtype="float32",
                       checkpoint_dir=str(ckpt), checkpoint_every=2,
                       log_file=str(log))
    params, metrics = TL.fit(tm.CLIPVisionConfig(**TINY), cfg, device="cpu")
    assert np.isfinite(metrics["loss"])
    assert metrics["accuracy"] > 0.7, metrics  # two well-separated colours
    assert C.TrainCheckpointer(ckpt).all_steps() == [2, 4, 6]
    assert json.loads((ckpt / "classes.json").read_text()) == ["a", "b"]
    # The exported tower loads into an inference tower.
    tower = tm.build_tower(params["tower"], tm.CLIPVisionConfig(**TINY),
                           device="cpu")
    assert tm.encode_image(tower, torch.zeros(1, 32, 32, 3)).shape == (1, 16)

    cfg2 = TL.FitConfig(root_dir=str(crop_tree), epochs=2, batch_size=8,
                        learning_rate=3e-3, compute_dtype="float32",
                        checkpoint_dir=str(ckpt), checkpoint_every=3,
                        lr_schedule="cosine", log_file=str(log))
    _, metrics2 = TL.fit(tm.CLIPVisionConfig(**TINY), cfg2, device="cpu")
    assert metrics2["accuracy"] >= 0.7
    resume, = _events(log, "resume")
    # Fixed behaviour, not the JAX package's: the cosine horizon counts the
    # restored 6 steps (6 + 2 epochs × 2 steps = 10). The JAX loop sets it
    # to this call's 4 steps, which the restored count 6 has passed, so its
    # whole resumed run trains at lr/100 (ADVICE.md, train/loop.py:70).
    assert resume["step"] == 6 and resume["total_steps"] == 10
    want_lr = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 1, 10, 3e-5)(6)
    np.testing.assert_allclose(resume["lr"], float(want_lr), rtol=1e-6)
    assert resume["lr"] > 3e-3 / 100 * 10
    # Checkpoints at 9 (every 3) and the end (10); the 3 newest are kept.
    assert C.TrainCheckpointer(ckpt).all_steps() == [6, 9, 10]


def test_fit_loss_tracks_jax_fit(crop_tree):
    """The same seed, tree, shuffles and augment draws in both packages:
    the last step's loss agrees to 2% and the accuracy exactly. Loosely,
    because AdamW's ±lr first step can flip for gradients near 0 between
    the two stacks (see the module docstring)."""
    kw = dict(root_dir=str(crop_tree), epochs=1, batch_size=8,
              learning_rate=3e-3, compute_dtype="float32", augment=True)
    _, want = JL.fit(jm.CLIPVisionConfig(**TINY), JL.FitConfig(**kw),
                     make_mesh({"dp": 8}))
    _, got = TL.fit(tm.CLIPVisionConfig(**TINY), TL.FitConfig(**kw),
                    device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-2)
    assert got["accuracy"] == want["accuracy"]


def test_jax_fit_records_are_a_subset_of_the_ports(crop_tree, tmp_path,
                                                   monkeypatch):
    """The port's ``FitConfig`` and epoch record may add fields of their
    own (``log_file``; ``steps`` and ``mean_loss``, listed in the README's
    port section), but every field and key of the JAX package's is there,
    so code written against the reference reads the port's records."""
    import dataclasses

    jax_fields = {f.name for f in dataclasses.fields(JL.FitConfig)}
    port_fields = {f.name for f in dataclasses.fields(TL.FitConfig)}
    assert jax_fields <= port_fields
    assert port_fields - jax_fields == {"log_file"}

    kw = dict(root_dir=str(crop_tree), epochs=1, batch_size=8,
              compute_dtype="float32")
    seen = []
    monkeypatch.setattr(
        JL.StageLogger, "event",
        lambda self, name, **fields: seen.append((name, set(fields))))
    JL.fit(jm.CLIPVisionConfig(**TINY), JL.FitConfig(**kw),
           make_mesh({"dp": 8}))
    jax_epoch, = (keys for name, keys in seen if name == "epoch")
    log = tmp_path / "log.jsonl"
    TL.fit(tm.CLIPVisionConfig(**TINY),
           TL.FitConfig(log_file=str(log), **kw), device="cpu")
    port_epoch, = _events(log, "epoch")
    assert jax_epoch <= set(port_epoch)
    assert set(port_epoch) - jax_epoch - {"stage", "event", "t"} == \
        {"steps", "mean_loss"}


def test_fit_refills_decode_failures(crop_tree, tmp_path):
    """A file that does not decode shrinks its batch; fit refills it by
    cycling the good samples and logs how many it repeated."""
    (crop_tree / "original_images" / "a" / "broken.png").write_bytes(b"no")
    log = tmp_path / "log.jsonl"
    _, metrics = TL.fit(tm.CLIPVisionConfig(**TINY), TL.FitConfig(
        root_dir=str(crop_tree), batch_size=17, compute_dtype="float32",
        log_file=str(log)), device="cpu")
    assert np.isfinite(metrics["loss"])
    refill, = _events(log, "refill")
    assert refill["repeated_samples"] == 1
    assert _events(log, "epoch")[0]["steps"] == 1


def test_fit_refuses_a_renamed_class(crop_tree, tmp_path):
    ckpt = tmp_path / "ckpt"
    kw = dict(root_dir=str(crop_tree), batch_size=8, compute_dtype="float32",
              checkpoint_dir=str(ckpt))
    TL.fit(tm.CLIPVisionConfig(**TINY), TL.FitConfig(**kw), device="cpu")
    (crop_tree / "original_images" / "b").rename(
        crop_tree / "original_images" / "c")
    with pytest.raises(ValueError, match="classes"):
        TL.fit(tm.CLIPVisionConfig(**TINY), TL.FitConfig(**kw), device="cpu")


def test_fit_errors_on_oversized_batch(crop_tree):
    cfg = TL.FitConfig(root_dir=str(crop_tree), batch_size=64,
                       compute_dtype="float32")
    with pytest.raises(ValueError, match="batch_size"):
        TL.fit(tm.CLIPVisionConfig(**TINY), cfg, device="cpu")


def test_fit_on_cuda_without_gpu_raises(crop_tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.fit(tm.CLIPVisionConfig(**TINY),
               TL.FitConfig(root_dir=str(crop_tree), batch_size=8))


def test_checkpointer_keeps_the_newest_and_restores(tmp_path):
    ck = C.TrainCheckpointer(tmp_path / "c", keep=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    for step in (1, 5, 7):
        ck.save(step, {"w": torch.full((2,), float(step)), "step": step})
    assert ck.all_steps() == [5, 7] and ck.latest_step() == 7
    assert ck.restore()["step"] == 7
    assert torch.equal(ck.restore(5)["w"], torch.full((2,), 5.0))
    (tmp_path / "c" / "9").mkdir()  # no state file: not a checkpoint
    assert ck.latest_step() == 7
    C.save_params({"a": {"b": torch.ones(3)}}, tmp_path / "p.pt")
    assert torch.equal(C.load_params(tmp_path / "p.pt")["a"]["b"],
                       torch.ones(3))
    assert not list(tmp_path.glob(".*.tmp"))
