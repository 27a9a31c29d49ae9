"""Training loop: fine-tune the CLIP tower on a labeled crop tree.

Walks a ``dataset_cropped``-style tree, builds (image, class-id) batches
with the prefetching loader, runs the train step on one device, logs
throughput, and checkpoints with resume (``utils.checkpoint``).

Unlike the JAX package's loop, a resumed run with ``lr_schedule="cosine"``
sets the schedule's horizon to the restored step plus this call's steps:
the restored optimizer count continues from the saved step, and a horizon
of this call's steps alone would leave the whole resumed run at the end
value lr/100.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from retrieval_based_object_detection_tpu_torch.models.clip import (
    model as clip_model,
)
from retrieval_based_object_detection_tpu_torch.models.clip import (
    preprocess as pp,
)
from retrieval_based_object_detection_tpu_torch.train import train as T
from retrieval_based_object_detection_tpu_torch.utils import tree
from retrieval_based_object_detection_tpu_torch.utils.checkpoint import (
    TrainCheckpointer,
)
from retrieval_based_object_detection_tpu_torch.utils.loader import (
    PrefetchIterator,
    batched,
)
from retrieval_based_object_detection_tpu_torch.utils.logging import (
    StageLogger,
    ThroughputTimer,
)


@dataclasses.dataclass
class FitConfig:
    root_dir: str
    img_type: str = "original"
    epochs: int = 1
    batch_size: int = 32
    learning_rate: float = 1e-4
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
    seed: int = 0
    compute_dtype: str = "bfloat16"
    head: str = "linear"  # "linear" | "cosine" (see train.TrainConfig)
    lr_schedule: str = "constant"  # "constant" | "cosine" (warmup+decay)
    # Train-time augmentation (label-preserving for product crops:
    # brightness jitter, wraparound translation, pixel noise — no flips
    # or right-angle rotations, which remap oriented textures across
    # classes). Stochastic per epoch.
    augment: bool = False
    # Where the stage logger appends its JSON records (resume, epoch,
    # checkpoint, summary); None logs to stderr only.
    log_file: str | None = None


def fit(
    clip_config: clip_model.CLIPVisionConfig,
    cfg: FitConfig,
    params=None,
    device: str | torch.device = "cuda",
) -> tuple[dict, dict]:
    """Runs the fine-tune; returns (final params ``{"tower", "head"}``,
    the last step's metrics as floats)."""
    entries = tree.walk(cfg.root_dir, cfg.img_type)
    classes = sorted({e.class_name for e in entries})
    class_to_id = {c: i for i, c in enumerate(classes)}
    if not entries:
        raise ValueError(
            f"no images under {cfg.root_dir}/{cfg.img_type}_images")
    steps_per_epoch = len(entries) // cfg.batch_size
    log = StageLogger("train", log_file=cfg.log_file)

    ckptr = None
    latest = None
    if cfg.checkpoint_dir:
        ckptr = TrainCheckpointer(cfg.checkpoint_dir)
        latest = ckptr.latest_step()
        # Pin the label mapping to the checkpoint: class_to_id derives
        # from the current tree, so resuming after a class was renamed or
        # swapped (same count, head shape matches) would silently train on
        # remapped supervision. classes.json records the mapping at first
        # save; a mismatch on resume fails loudly.
        classes_file = Path(cfg.checkpoint_dir) / "classes.json"
        if latest is not None and classes_file.exists():
            saved = json.loads(classes_file.read_text())
            if saved != classes:
                raise ValueError(
                    f"checkpoint {cfg.checkpoint_dir} was trained on "
                    f"classes {saved} but the tree now has {classes}; "
                    "label ids would be silently remapped — train into "
                    "a fresh checkpoint dir (or restore the tree)")
        if not classes_file.exists():
            classes_file.parent.mkdir(parents=True, exist_ok=True)
            classes_file.write_text(json.dumps(classes))
    start_step = latest or 0

    tcfg = T.TrainConfig(
        num_classes=len(classes), learning_rate=cfg.learning_rate,
        compute_dtype=cfg.compute_dtype, head=cfg.head,
        lr_schedule=cfg.lr_schedule,
        total_steps=max(start_step + cfg.epochs * steps_per_epoch, 1))
    model, optimizer = T.init_state(clip_config, tcfg, seed=cfg.seed,
                                    params=params, device=device)
    step_fn = T.make_train_step(tcfg)
    if latest is not None:
        restored = ckptr.restore(latest, map_location=model.device)
        model.load_state_dict(restored["params"])
        optimizer.load_state_dict(restored["opt_state"])
        log.event("resume", step=start_step, total_steps=tcfg.total_steps,
                  lr=optimizer.schedule(optimizer.count))

    def save(step: int) -> None:
        ckptr.save(step, {"params": model.state_dict(),
                          "opt_state": optimizer.state_dict()})
        log.event("checkpoint", step=step)

    timer = ThroughputTimer("images")
    rng = np.random.default_rng(cfg.seed)
    aug_rng = np.random.default_rng(cfg.seed + 7919)
    # Brightness jitter operates on raw pixel values; in normalised space
    # (x - m)/s a raw scale b becomes b·x + (b-1)·m/s.
    mean_over_std = (pp.CLIP_MEAN / pp.CLIP_STD).astype(np.float32)
    metrics: dict[str, torch.Tensor] = {}
    step = start_step

    def augment(arr: np.ndarray) -> np.ndarray:
        b = np.float32(aug_rng.uniform(0.85, 1.15))
        arr = b * arr + (b - 1.0) * mean_over_std
        s = arr.shape[0]
        ty, tx = aug_rng.integers(-(s // 8), s // 8 + 1, size=2)
        # Wraparound translation: cheap, static-shape; the wrapped strip
        # is background/clutter, never the (centered) object.
        arr = np.roll(arr, (ty, tx), axis=(0, 1))
        arr = arr + aug_rng.normal(0.0, 0.04, arr.shape)
        return arr.astype(np.float32)

    def prepare(chunk):
        imgs, labels = [], []
        for e in chunk:
            arr = pp.load_and_preprocess(e.path, size=clip_config.image_size)
            if arr is None:
                continue
            imgs.append(augment(arr) if cfg.augment else arr)
            labels.append(class_to_id[e.class_name])
        return imgs, labels

    model.train()
    for epoch in range(cfg.epochs):
        order = rng.permutation(len(entries))
        shuffled = [entries[i] for i in order]
        # Drop the ragged tail: every step takes one batch shape.
        full = shuffled[: len(shuffled) - len(shuffled) % cfg.batch_size]
        if not full:
            raise ValueError(
                f"batch_size {cfg.batch_size} exceeds dataset size "
                f"{len(shuffled)}")
        loader = PrefetchIterator(batched(full, cfg.batch_size), prepare)
        n_fill, n_steps, loss_sum = 0, 0, 0.0
        try:
            for imgs, labels in loader:
                if not imgs:
                    continue
                # Decode failures shrink the batch; refill by cycling the
                # good samples instead of dropping the whole batch —
                # counted and logged below.
                orig_n = len(imgs)
                while len(imgs) < cfg.batch_size:
                    j = (len(imgs) - orig_n) % orig_n
                    imgs.append(imgs[j])
                    labels.append(labels[j])
                    n_fill += 1
                metrics = step_fn(model, optimizer, np.stack(imgs),
                                  np.asarray(labels, np.int64))
                loss_sum = loss_sum + metrics["loss"]  # stays on the device
                n_steps += 1
                step += 1
                timer.add(len(imgs))
                if ckptr and step % cfg.checkpoint_every == 0:
                    save(step)
        finally:
            loader.close()
        if n_fill:
            log.event("refill", repeated_samples=n_fill)
        if not metrics:
            raise ValueError(
                "no trainable batches survived decoding — check the tree "
                f"under {cfg.root_dir}")
        log.event("epoch", epoch=epoch, steps=n_steps,
                  loss=round(float(metrics["loss"]), 4),
                  mean_loss=float(loss_sum) / max(n_steps, 1),
                  accuracy=round(float(metrics["accuracy"]), 4),
                  throughput=round(timer.per_sec, 1))

    if ckptr and ckptr.latest_step() != step:
        save(step)
    log.summary(steps=step, classes=len(classes))
    return model.export(), {k: float(v) for k, v in metrics.items()}
