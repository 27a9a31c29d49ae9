"""Traffic kind ``embed_tree``: offline ingest of a cropped dataset
(``rbod embed``): ``embed_tree`` over a directory tree of JPEG crops,
upserting into one gallery.

Set-up: seeded CLIP weights on the card; a tree of ``crops`` seeded JPEG
crops (sides drawn from ``min_side``..``max_side``, ``classes`` classes)
under ``TMPDIR`` in the stage layout
``dataset_cropped/original_images/<class>/<file>``; the encoder
(``make_encoder``, the configuration's embedding type) wrapped in a span;
one whole pass of ``embed_tree``, so that every pass of the window
overwrites the same points.

Window: ``embed_tree`` over the whole tree again and again, until
``seconds`` have passed at the end of a pass. With ``--trace 1`` one
more pass follows under the profiler.

End to end: ``embed_crops_per_s``, crops embedded and upserted over the
window's seconds.

Check: a seeded sample of the crops, each decoded and preprocessed by
``reference.embed`` and embedded by ``reference.clip`` in f32 with TF32
off, against the vector the gallery stored under the crop's point id
(the MD5 of its resolved path), and every payload field.
"""

from __future__ import annotations

import hashlib
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from benchcore import images as imgs
from benchcore.context import MISSING, Outcome
from benchcore.device import device_block
from benchcore.port import clip_config
from benchcore.weights import clip_state


def write_tree(seed: int, p: dict, root: Path) -> list[tuple[Path, str]]:
    """The seeded crops as JPEG files → (path, class name) of each."""
    out = []
    for i in range(p["crops"]):
        rng = imgs.rng_for(seed, 30, i)
        c = i % p["classes"]
        name = f"class_{c:03d}"
        h, w = (int(v) for v in rng.integers(p["min_side"],
                                             p["max_side"] + 1, 2))
        d = root / "original_images" / name
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"crop_{i:05d}.jpg"
        path.write_bytes(imgs.jpeg(imgs.synthetic_crop(
            rng, imgs.class_color(c), h, w), p["jpeg_quality"]))
        out.append((path, name))
    return out


def point_id(path: Path) -> str:
    """The payload contract's point id: MD5 of the resolved path."""
    return hashlib.md5(str(Path(path).resolve()).encode()).hexdigest()


def judge(torch, run, files, records, n_rows: int, state) -> dict:
    """Stored vectors and payloads of the sampled crops against the
    reference: the widest relative vector gap, payload fields that
    differ, and rows more or fewer than crops."""
    from reference import clip
    from reference import embed as ref

    cfg = run.cfg
    x = torch.as_tensor(np.stack([ref.preprocess(str(path), cfg["image_size"])
                                  for path, _ in files]), device=run.device)
    want = clip.encode_blocks(state, cfg, x).cpu().numpy()
    vec, fields = 0.0, 0
    for (path, name), rec, w in zip(files, records, want):
        if rec is None:
            return {"vector_rel": MISSING, "payload_fields": MISSING,
                    "row_count": MISSING}
        got = np.asarray(rec.vector, np.float64)
        vec = max(vec, float(np.linalg.norm(got - w) / np.linalg.norm(w)))
        pl = rec.payload
        expect = {"data_type": "original_images", "class_name": name,
                  "img_path": str(path), "is_cropped": True,
                  "is_segmented": False, "is_augmented": False,
                  "is_delegate": False, "delegate_type": None}
        fields += sum(getattr(pl, k) != v for k, v in expect.items())
    return {"vector_rel": vec, "payload_fields": fields,
            "row_count": abs(n_rows - run.params["crops"])}


def run(run) -> Outcome:
    torch = run.torch
    from retrieval_based_object_detection_tpu_torch.gallery.store import (
        Gallery,
    )
    from retrieval_based_object_detection_tpu_torch.pipelines import embed

    p, cfg = run.params, run.cfg
    state = clip_state(torch, cfg, run.seed, run.device)
    workdir = Path(tempfile.mkdtemp(prefix="pb-embed-"))
    try:
        root = workdir / "dataset_cropped"
        files = write_tree(run.seed, p, root)
        encoder = embed.make_encoder(state, clip_config(cfg),
                                     cfg["embed_dtype"], device=run.device)

        def timed(batch):
            with run.spans.span("encode", batch=len(batch)):
                return encoder(batch)

        gallery = Gallery("bench", dim=cfg["embed_dim"],
                          capacity=p["crops"] + 64, device=run.device)
        ecfg = embed.EmbedConfig(root_dir=str(root), img_type="original",
                                 batch_size=cfg["embed_batch"],
                                 image_size=cfg["image_size"])
        embed.embed_tree(gallery, timed, ecfg)     # the first pass inserts
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        prof = run.profiler()
        run.spans.reset()
        run.setup_done()
        t0 = time.perf_counter()
        crops = failed = passes = 0
        pass_s = []
        while not passes or time.perf_counter() - t0 < run.seconds:
            t_pass = time.perf_counter()
            result = embed.embed_tree(gallery, timed, ecfg)
            pass_s.append(time.perf_counter() - t_pass)
            crops += result.total
            failed += result.n_failed
            passes += 1
        window_s = time.perf_counter() - t0
        device = device_block(torch, run.device, run.spec["chips"])
        run.log(passes=passes, pass_s=pass_s, crops=crops, window_s=window_s,
                crops_per_s=crops / window_s, failed=failed)
        encodes = run.spans.of("encode")
        trace = None
        if prof is not None:
            # After the window, one more pass under the profiler, which
            # slows every launch; the window's numbers are taken without.
            prof.start()
            embed.embed_tree(gallery, timed, ecfg)
            trace = prof.stop()
        layer = {"traffic": "embed_tree", "cfg": cfg, "params": p,
                 "encodes": encodes, "crops": crops,
                 "window_s": window_s, "trace": trace}
        # The check: the stored rows are the program's output; the
        # reference runs once the program's state is freed.
        rng = imgs.rng_for(run.seed, 3, 0)
        pick = np.sort(rng.choice(len(files), min(p["check_crops"],
                                                  len(files)),
                                  replace=False))
        sample = [files[i] for i in pick]
        recs = {r.id: r for r in gallery.retrieve(
            [point_id(path) for path, _ in sample], with_vectors=True)}
        records = [recs.get(point_id(path)) for path, _ in sample]
        n_rows = len(gallery)
        del gallery, encoder, timed
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        nums = judge(torch, run, sample, records, n_rows, state)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    checks = [run.check("failed_crops", failed)]
    checks += [run.check(k, v) for k, v in nums.items()]
    return Outcome(
        attempted=crops + failed, failed=failed,
        end_to_end={"embed_crops_per_s": (crops / window_s, "crops/s")},
        checks=checks, device=device, layer=layer)


def control(run) -> dict:
    """The control's numbers: the reference with TF32 on (the step below
    the configuration's f32 with TF32 off) put in the program's place on
    the seeded sample of the tree's crops, its vectors stored with the
    right payloads, judged as the gallery's rows are."""
    from types import SimpleNamespace

    torch = run.torch
    from reference import clip
    from reference import embed as ref

    p, cfg = run.params, run.cfg
    state = clip_state(torch, cfg, run.seed, run.device)
    workdir = Path(tempfile.mkdtemp(prefix="pb-embed-"))
    try:
        files = write_tree(run.seed, p, workdir / "dataset_cropped")
        rng = imgs.rng_for(run.seed, 3, 0)
        pick = np.sort(rng.choice(len(files), min(p["check_crops"],
                                                  len(files)),
                                  replace=False))
        sample = [files[i] for i in pick]
        x = torch.as_tensor(np.stack([ref.preprocess(str(path),
                                                     cfg["image_size"])
                                      for path, _ in sample]),
                            device=run.device)
        vecs = clip.encode_blocks(state, cfg, x, mm=clip.tf32_mm)
        records = [SimpleNamespace(vector=v.cpu().numpy(), payload=(
            SimpleNamespace(data_type="original_images", class_name=name,
                            img_path=str(path), is_cropped=True,
                            is_segmented=False, is_augmented=False,
                            is_delegate=False, delegate_type=None)))
                   for (path, name), v in zip(sample, vecs)]
        return {"failed_crops": 0, **judge(torch, run, sample, records,
                                           p["crops"], state)}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
