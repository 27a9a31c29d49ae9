#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: its serving and offline paths on
one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from ``csrc/`` (one nvcc per source, all
started together) and holds each against its plain PyTorch version at the
shapes its path gives it. Then it drives two paths through the calls a
user makes, with a full-width CLIP ViT-B/32 from seeded weights:

- serving: a few hundred synthetic crops are embedded into a Gallery,
  ``build_delegates`` runs, ``serve_http`` answers concurrent
  ``POST /detect`` requests, and a 1,048,576 x 512 gallery answers
  ``Gallery.search(exact=False)`` through the int8 scan;
- offline: ``embed_tree`` over a synthetic dataset tree, 12,000 crops of
  one class through ``embed_arrays`` (a group past the blocked-medoid
  threshold), ``build_delegates``, ``run_experiments`` in both match
  modes writing CSV/npy, and ``search(method="int4")`` on the 1M-row
  gallery.

Kernel launch counters are zeroed just before each path and read just
after it.

Prints one JSON line per phase, then the kernel table as one JSON line,
the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without that
last line; so does a machine without CUDA, or a directory without the
port next to this script.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import io
import json
import math
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

ATTN_SOURCE = "retrieval_based_object_detection_tpu_torch/csrc/clip_attention.cu"
ATTN_REPLACES = "retrieval_based_object_detection_tpu/ops/clip_attention.py:30"
SCAN_SOURCE = "retrieval_based_object_detection_tpu_torch/csrc/int8_scan.cu"
SCAN_REPLACES = "retrieval_based_object_detection_tpu/ops/int8_scan.py:59"
INT4_SOURCE = "retrieval_based_object_detection_tpu_torch/csrc/int4_scan.cu"
INT4_REPLACES = "retrieval_based_object_detection_tpu/ops/int4_scan.py:80"
MEDOID_SOURCE = "retrieval_based_object_detection_tpu_torch/csrc/medoid.cu"
MEDOID_REPLACES = "retrieval_based_object_detection_tpu/ops/medoid.py:23"
MEDOID_RTOL, MEDOID_ATOL = 1e-4, 5e-2  # tests/test_pallas_medoid.py

COLORS = [(220, 40, 40), (40, 40, 220), (40, 190, 60), (230, 200, 30),
          (150, 60, 200), (30, 200, 200), (240, 120, 20), (90, 90, 90)]


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float, op_type: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_phase(torch, F, CA, seed: int) -> dict:
    """B1 against its plain version at the serving shape, bf16 and f32."""
    B, T, H, D = 64, 50, 12, 64
    W = H * D
    g = torch.Generator(device="cpu").manual_seed(seed)
    base = torch.randn(B, T, 3 * W, generator=g).cuda()
    # bf16: p and the output may round to neighbouring bf16 values (the
    # same f32 sums in another order): one ulp of p (2^-9 near 0.5) times
    # |v| <= ~4, plus one ulp of the output.
    tols = {"bfloat16": (1e-2, 2 ** -7), "float32": (1e-5, 1e-5)}
    out = {}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        qkv = base.to(dtype)
        got = CA.clip_attention_core(qkv, heads=H)
        torch.cuda.synchronize()
        want = CA.clip_attention_core_plain(qkv, heads=H)
        atol, rtol = tols[name]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        err = float((got.float() - want.float()).abs().max())
        q, k, v = (t.view(B, T, H, D).transpose(1, 2)
                   for t in qkv.split(W, dim=-1))
        size = qkv.element_size()
        n_bytes = B * T * 3 * W * size + B * T * W * size
        # QK^T and PV (2 flops per multiply-add each) plus ~5 per logit
        # for scale, max, subtract, exp and divide.
        n_ops = B * H * (4 * T * T * D + 5 * T * T)
        b_ms, b_by = bound_ms(n_bytes, n_ops, name)
        out[name] = {
            "max_abs_err": err, "atol": atol, "rtol": rtol,
            "ms": cuda_ms(torch, lambda: CA.clip_attention_core(qkv, H)),
            "plain_ms": cuda_ms(
                torch, lambda: CA.clip_attention_core_plain(qkv, H)),
            "library_ms": cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    log("attention_kernel_vs_plain", shape=[B, T, 3 * W], **out)
    return out


def scan_phase(torch, S, seed: int) -> dict:
    """B2 against its plain version at Q=16 x N=1,048,576 x 512, bit-exact."""
    Q, N, D = 16, 1 << 20, 512
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    q = torch.randint(-127, 128, (Q, D), generator=g, dtype=torch.int8).cuda()
    rows = torch.randint(-127, 128, (N, D), generator=g,
                         dtype=torch.int8).cuda()
    pen = torch.where(torch.rand(N, generator=g) < 0.1, -1e30, 0.0).cuda()
    got = S.int8_scan_scores(q, rows, pen)
    torch.cuda.synchronize()
    want = S.int8_scan_scores_plain(q, rows, pen)
    if not torch.equal(got, want):
        raise AssertionError(
            "int8 scan differs from its plain version: max abs err "
            f"{float((got - want).abs().max())}")
    rows_bf16 = rows.to(torch.bfloat16)
    q_bf16 = q.to(torch.bfloat16)
    n_bytes = Q * D + N * D + 4 * N + 4 * Q * N
    b_ms, b_by = bound_ms(n_bytes, 2 * Q * N * D, "int8")
    out = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: S.int8_scan_scores(q, rows, pen)),
        "plain_ms": cuda_ms(
            torch, lambda: S.int8_scan_scores_plain(q, rows, pen), reps=3,
            warmup=1),
        "library_ms": cuda_ms(torch, lambda: q_bf16 @ rows_bf16.T),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    log("scan_kernel_vs_plain", shape=[Q, N, D], **out)
    return out


def int4_phase(torch, S4, seed: int) -> dict:
    """B3 against its plain version at Q=16 x N=1,048,576 x 512, bit-exact,
    with the query halves drawn apart so a lo/hi swap would show."""
    Q, N, D = 16, 1 << 20, 512
    g = torch.Generator(device="cpu").manual_seed(seed + 4)
    q = torch.randint(-127, 128, (Q, D), generator=g, dtype=torch.int8)
    q[:, D // 2:] //= 3
    packed = torch.randint(-128, 128, (N, D // 2), generator=g,
                           dtype=torch.int8)
    scales = torch.rand(N, generator=g) * 0.2 + 1e-3
    pen = torch.where(torch.rand(N, generator=g) < 0.1, -1e30, 0.0)
    q, packed, scales, pen = (t.cuda() for t in (q, packed, scales, pen))
    got = S4.int4_scan_scores(q, packed, scales, pen)
    torch.cuda.synchronize()
    want = S4.int4_scan_scores_plain(q, packed, scales, pen)
    if not torch.equal(got, want):
        raise AssertionError(
            "int4 scan differs from its plain version: max abs err "
            f"{float((got - want).abs().max())}")
    del got, want
    rows_bf16 = S4.unpack_int4(packed).to(torch.bfloat16)
    q_bf16 = q.to(torch.bfloat16)
    n_bytes = Q * D + N * D // 2 + 8 * N + 4 * Q * N
    b_ms, b_by = bound_ms(n_bytes, 2 * Q * N * D, "int8")
    out = {
        "max_abs_err": 0.0,
        "ms": cuda_ms(torch, lambda: S4.int4_scan_scores(q, packed, scales,
                                                         pen)),
        "plain_ms": cuda_ms(
            torch, lambda: S4.int4_scan_scores_plain(q, packed, scales, pen),
            reps=3, warmup=1),
        "library_ms": cuda_ms(torch, lambda: q_bf16 @ rows_bf16.T),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    log("int4_kernel_vs_plain", shape=[Q, N, D], **out)
    return out


def medoid_agrees(i: int, plain) -> bool:
    """Row ``i`` is the plain sums' medoid, or has a plain sum within the
    medoid tolerance of the plain minimum."""
    lo = float(plain.min())
    return i == int(plain.argmin()) or \
        float(plain[i]) - lo <= MEDOID_ATOL + MEDOID_RTOL * lo


def medoid_phase(torch, M, seed: int) -> dict:
    """B4 against its plain version at N=12,000 (not a tile multiple) x
    512 seeded unit rows."""
    N, D = 12_000, 512
    g = torch.Generator(device="cpu").manual_seed(seed + 5)
    x = torch.nn.functional.normalize(torch.randn(N, D, generator=g),
                                      dim=1).cuda()
    got = M.pairwise_distance_sums(x)
    torch.cuda.synchronize()
    want = M.pairwise_distance_sums_plain(x)
    torch.testing.assert_close(got, want, rtol=MEDOID_RTOL,
                               atol=MEDOID_ATOL)
    if not medoid_agrees(int(got.argmin()), want):
        raise AssertionError("medoid kernel's argmin is not the plain one")
    if not torch.equal(M.pairwise_distance_sums(x), got):
        raise AssertionError("medoid kernel sums differ between runs")
    # The sums need each unordered pair's distance once: N(N-1)/2 dot
    # products of 2D operations each.
    b_ms, b_by = bound_ms(4 * N * D + 4 * N, N * (N - 1) * D, "float32")
    out = {
        "max_abs_err": float((got - want).abs().max()),
        "rtol": MEDOID_RTOL, "atol": MEDOID_ATOL,
        "argmin_kernel": int(got.argmin()), "argmin_plain": int(want.argmin()),
        "ms": cuda_ms(torch, lambda: M.pairwise_distance_sums(x), reps=5,
                      warmup=1),
        "plain_ms": cuda_ms(torch, lambda: M.pairwise_distance_sums_plain(x),
                            reps=5, warmup=1),
        "library_ms": cuda_ms(torch, lambda: torch.cdist(x, x).sum(1),
                              reps=5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    log("medoid_kernel_vs_plain", shape=[N, D], **out)
    return out


def synthetic_crop(np, rng, color, size=224):
    """A product-like crop: a coloured rectangle on a light background with
    mild noise, uint8 [size, size, 3]."""
    img = np.full((size, size, 3), 225, np.uint8)
    y0, x0 = rng.integers(20, 50, 2)
    y1, x1 = size - rng.integers(20, 50, 2)
    img[y0:y1, x0:x1] = color
    return np.clip(img + rng.integers(0, 12, img.shape), 0, 255
                   ).astype(np.uint8)


def scene(np, rng, color, h, w):
    img = np.full((h, w, 3), 230, np.uint8)
    img[h // 4: 3 * h // 4, w // 5: 3 * w // 5] = color
    return np.clip(img + rng.integers(0, 10, img.shape), 0, 255
                   ).astype(np.uint8)


def serving_phase(torch, np, port, seed: int) -> dict:
    """The serving path at full ViT-B/32 width: embed_arrays → Gallery →
    build_delegates → RetrievalDetector behind serve_http."""
    from PIL import Image

    clip_model = port["clip_model"]
    cfg = clip_model.VIT_B_32
    t0 = time.perf_counter()
    params = clip_model.params_from_jax(clip_model.init_params(cfg, seed))
    rng = np.random.default_rng(seed)
    per_class, classes = 32, [f"class{i}" for i in range(len(COLORS))]
    crops, paths, names = [], [], []
    for c, color in zip(classes, COLORS):
        for i in range(per_class):
            crops.append(synthetic_crop(np, rng, color))
            paths.append(f"/synthetic/{c}/{i}.png")
            names.append(c)
    mean = port["preprocess"].CLIP_MEAN
    std = port["preprocess"].CLIP_STD
    batch = (np.stack(crops).astype(np.float32) / 255.0 - mean) / std

    gallery = port["store"].Gallery("serving", dim=cfg.embed_dim,
                                    device="cuda")
    encoder = port["embed"].make_encoder(params, cfg, device="cuda")
    t_embed = time.perf_counter()
    n = port["embed"].embed_arrays(gallery, encoder, batch, paths, names,
                                   batch_size=64)
    embed_s = time.perf_counter() - t_embed
    embed_batches = math.ceil(n / 64)
    built = port["delegates"].build_delegates(gallery)
    if built.n_delegates_written != 4 * len(classes):
        raise AssertionError(f"delegates: {built.n_delegates_written}")

    # Reference check: the f32 embeddings from the card (attention kernel)
    # against the plain attention path on the CPU, on a few crops.
    ref_tower = clip_model.build_tower(params, cfg, device="cpu")
    sample = batch[:: len(batch) // 4][:4]
    ref = clip_model.encode_image(ref_tower, torch.from_numpy(sample))
    card = torch.from_numpy(encoder(sample))
    cos = torch.nn.functional.cosine_similarity(ref, card, dim=1)
    emb_err = float((ref - card).abs().max() / ref.abs().max())
    if not (cos.min() > 0.9999 and emb_err < 1e-3):
        raise AssertionError(f"card vs CPU embeddings: cos {cos.tolist()}, "
                             f"rel err {emb_err}")

    detector = port["serve"].RetrievalDetector(params, gallery, cfg,
                                               device="cuda")
    srv = port["serve"].serve_http(detector, host="127.0.0.1", port=0,
                                   serving_size=512, max_batch=16,
                                   batch_wait_ms=50)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    truth = [i % len(classes) for i in range(12)]
    uploads = []
    for i, c in enumerate(truth):
        buf = io.BytesIO()
        Image.fromarray(scene(np, rng, COLORS[c], 360 + 8 * i, 480)
                        ).save(buf, "PNG")
        uploads.append(buf.getvalue())

    def post(data):
        t = time.perf_counter()
        req = urllib.request.Request(base + "/detect", data=data,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read()), (time.perf_counter() - t) * 1e3

    try:
        # One request alone first: it pays the process's first-call costs
        # (lazy kernel loading, GEMM heuristics) so the burst after it
        # measures the warm path.
        _, first_ms = post(uploads[0])
        t_req = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(uploads)) as ex:
            answers = list(ex.map(post, uploads))
        wall = time.perf_counter() - t_req
        dets = [d for d, _ in answers]
        burst_ms = sorted(ms for _, ms in answers)
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    if health != {"ok": True} or stats["errors"] or \
            stats["requests"] != len(uploads) + 1:
        raise AssertionError(f"server: {health} {stats}")
    for i, det in enumerate(dets):
        h = 360 + 8 * i
        for d in det["detections"]:
            x1, y1, x2, y2 = d["box"]
            if not (0 <= x1 < x2 <= 480 and 0 <= y1 < y2 <= h):
                raise AssertionError(f"bad box {d}")
            if d["class_name"] not in classes or not \
                    -1.0 <= d["similarity"] <= 1.0 + 1e-6 or not \
                    math.isfinite(d["confidence"]):
                raise AssertionError(f"bad detection {d}")
    dispatches = sum(stats["batch_sizes"].values())
    correct = sum(classes[t] == d["class_name"] for t, d in zip(truth, dets))
    out = {"crops_embedded": n, "embed_batches": embed_batches,
           "embed_s_host_clock": embed_s,
           "delegates": built.n_delegates_written,
           "embedding_cos_vs_cpu_min": float(cos.min()),
           "embedding_rel_err_vs_cpu": emb_err,
           "first_request_ms": first_ms,
           "burst_requests": len(uploads), "dispatches": dispatches,
           "batch_sizes": stats["batch_sizes"],
           "burst_latency_ms_client": burst_ms,
           "burst_wall_s": wall,
           "top1_class_matches_scene_colour": f"{correct}/{len(truth)}",
           "seconds": time.perf_counter() - t0}
    log("serving_path", **out)
    return out, detector, params


def breakdown_phase(torch, np, port, detector, seed: int) -> dict:
    """Where one warm serving dispatch goes: ``detect`` on 8 canvases of
    512 px and its stages alone (CUDA events around 5 calls each, after a
    warm-up call; ``detect`` ends in device→host copies)."""
    rng = np.random.default_rng(seed + 3)
    canvases = np.stack([scene(np, rng, COLORS[i], 512, 512)
                         for i in range(8)])
    images = torch.as_tensor(canvases, device=detector.device)
    x = images.float()
    boxes, _ = port["saliency"].propose_boxes(x, max_boxes=detector.max_boxes)

    size = detector.tower.config.image_size

    def crops():
        return torch.cat([port["image"].crop_resize_batch(x, boxes[:, k], size)
                          for k in range(boxes.shape[1])])

    batch = crops()
    out = {"canvases": list(images.shape), "crops": batch.shape[0]}
    for name, fn in (
            ("detect_ms", lambda: detector.detect(images)),
            ("propose_boxes_ms", lambda: port["saliency"].propose_boxes(
                x, max_boxes=detector.max_boxes)),
            ("crop_resize_ms", crops),
            ("encode_bf16_ms", lambda: port["clip_model"].encode_image(
                detector.tower, batch))):
        out[name] = cuda_ms(torch, fn, reps=5, warmup=1)
    log("serving_breakdown", **out)
    return out


def gallery_phase(torch, np, port, seed: int) -> dict:
    """A 1,048,576 x 512 gallery: search(exact=False) must auto-route to
    the int8 scan and return exact search's top-10 ids."""
    store = port["store"]
    Payload = port["schema"].Payload
    N, D, Q, k = 1 << 20, 512, 16, 10
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 2)
    gallery = store.Gallery("scale", dim=D, capacity=N, device="cuda")
    pls = [Payload(data_type="original_images", class_name=f"c{i}",
                   img_path="") for i in range(8)]
    chunk = 131_072
    for lo in range(0, N, chunk):
        vecs = rng.standard_normal((chunk, D), dtype=np.float32)
        gallery.upsert([f"row-{i}" for i in range(lo, lo + chunk)], vecs,
                       [pls[i % 8] for i in range(lo, lo + chunk)])
    fill_s = time.perf_counter() - t0
    picks = rng.choice(N, Q, replace=False)
    queries = gallery._vectors[picks] + 0.5 * rng.standard_normal(
        (Q, D), dtype=np.float32)
    before = port["int8_scan"].KERNEL.launches
    t1 = time.perf_counter()
    approx = gallery.search(queries, k=k, exact=False)
    first_s = time.perf_counter() - t1
    if gallery._dev_int8 is None or \
            port["int8_scan"].KERNEL.launches == before:
        raise AssertionError("exact=False did not route to the int8 scan")
    exact = gallery.search(queries, k=k, method="exact")
    # Compared as sets: torch.topk promises no order among equal scores.
    for a, e in zip(approx, exact):
        if {h.id for h in a} != {h.id for h in e}:
            raise AssertionError("int8 top-10 ids differ from exact")
    flt = port["schema"].Filter(must={"class_name": "c3"})
    fa = gallery.search(queries, k=k, flt=flt, exact=False)
    fe = gallery.search(queries, k=k, flt=flt, method="exact")
    for a, e in zip(fa, fe):
        if {h.id for h in a} != {h.id for h in e} or \
                any(h.payload.class_name != "c3" for h in a):
            raise AssertionError("filtered int8 top-10 differs from exact")
    steady = []
    for _ in range(5):
        t2 = time.perf_counter()
        gallery.search(queries, k=k, exact=False)
        steady.append((time.perf_counter() - t2) * 1e3)
    out = {"rows": N, "dim": D, "queries": Q, "k": k, "fill_s": fill_s,
           "first_search_s": first_s,
           "search_ms_host_clock": sorted(steady),
           "top10_equal_exact": True,
           "self_hit_top1": sum(int(f"row-{p}" == a[0].id)
                                for p, a in zip(picks, approx)),
           "seconds": time.perf_counter() - t0}
    log("gallery_int8_search", **out)
    return out, gallery, queries, picks


def write_tree(np, root, seed: int, per_class=(32, 8)) -> int:
    """A synthetic dataset tree: dataset_cropped (RGB) and
    dataset_segmented (RGBA, as segmented crops are) PNGs of 8 colour
    classes, ``per_class`` original and natural images each, in sizes that
    make the PIL path resize and crop. Encoded on 8 threads."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    jobs = []
    for stage in ("dataset_cropped", "dataset_segmented"):
        for img_type, count in zip(("original", "natural"), per_class):
            for c, color in enumerate(COLORS):
                d = root / stage / f"{img_type}_images" / f"class{c}"
                d.mkdir(parents=True)
                for i in range(count):
                    h, w = rng.integers(200, 300, 2)
                    jobs.append((scene(np, rng, color, h, w),
                                 stage == "dataset_segmented",
                                 d / f"img_{i}.png"))

    def save(job):
        arr, alpha, path = job
        img = Image.fromarray(arr)
        if alpha:
            img.putalpha(255)
        img.save(path, compress_level=1)

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        list(ex.map(save, jobs))
    return len(jobs)


def large_class_chunks(torch, np, rng, mean, std, n: int, chunk: int = 1024):
    """``n`` preprocessed crops of one class, ``chunk`` at a time (about
    0.6 GB of f32 at 224 px): colour and shift jitter of a few base crops,
    the kind of set the augment stage's n_aug 10 makes of product photos.
    The jitter runs on the card; the crops come back as host arrays, as a
    loader would hand them to ``embed_arrays``."""
    pad, size = 12, 224
    bases = torch.from_numpy(np.stack([
        synthetic_crop(np, rng, COLORS[0], size + 2 * pad)
        for _ in range(8)])).cuda()
    mean, std = torch.from_numpy(mean).cuda(), torch.from_numpy(std).cuda()
    g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 31)))
    ramp = torch.arange(size).cuda()
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        pick = torch.randint(0, len(bases), (m, 1, 1), generator=g).cuda()
        dy, dx = torch.randint(0, 2 * pad + 1, (2, m, 1), generator=g).cuda()
        tint = torch.randint(-25, 26, (m, 1, 1, 3), generator=g).cuda()
        px = bases[pick, (dy + ramp)[:, :, None], (dx + ramp)[:, None, :]]
        px = torch.clamp(px.float() + tint, 0, 255)
        yield lo, ((px / 255.0 - mean) / std).cpu().numpy()


def experiment_phase(torch, np, port, params, seed: int) -> dict:
    """The offline path at full ViT-B/32 width (f32 tower): embed_tree over
    a synthetic tree, a 12,000-member class through embed_arrays,
    build_delegates (that class's medoid through B4), run_experiments in
    both match modes writing CSV/npy."""
    import csv
    import tempfile
    from pathlib import Path

    cfg = port["clip_model"].VIT_B_32
    embed, xp = port["embed"], port["experiments"]
    M = port["medoid"]
    t0 = time.perf_counter()
    encoder = embed.make_encoder(params, cfg, device="cuda")
    gallery = port["store"].Gallery("offline", dim=cfg.embed_dim,
                                    device="cuda")
    out = {"tower": "float32", "batch": 64}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        out["tree_images"] = write_tree(np, root, seed + 6)
        out["tree_write_s"] = time.perf_counter() - t
        batches, n_tree = 0, 0
        t = time.perf_counter()
        for stage in ("dataset_cropped", "dataset_segmented"):
            for img_type in ("original", "natural"):
                res = embed.embed_tree(gallery, encoder, embed.EmbedConfig(
                    root_dir=str(root / stage), img_type=img_type,
                    batch_size=64))
                if res.n_failed:
                    raise AssertionError(f"embed_tree failed {res.n_failed}")
                batches += math.ceil(res.total / 64)
                n_tree += res.total
        out["embed_tree_s"] = time.perf_counter() - t
        out["embed_tree_crops_per_s"] = n_tree / out["embed_tree_s"]
        if n_tree != out["tree_images"]:
            raise AssertionError(f"embedded {n_tree} of "
                                 f"{out['tree_images']} images")
        # Where embed_tree's time goes: the host decode + PIL preprocess of
        # every tree image alone, and one 64-crop f32 encode (host-to-device
        # copy, tower, device-to-host copy) alone.
        entries = [e for stage in ("dataset_cropped", "dataset_segmented")
                   for img_type in ("original", "natural")
                   for e in port["tree"].walk(root / stage, img_type)]
        t = time.perf_counter()
        arrs = port["loader"].parallel_map(
            lambda e: port["preprocess"].load_and_preprocess(e.path),
            entries)
        out["tree_decode_preprocess_s"] = time.perf_counter() - t
        batch = np.stack(arrs[:64])
        del arrs
        out["encode_64_f32_ms"] = cuda_ms(torch, lambda: encoder(batch),
                                          reps=5, warmup=1)
        timing_encodes = 6  # the warm-up and 5 timed calls, B1 12 times each

        n_large = 12_000
        rng = np.random.default_rng(seed + 7)
        mean = port["preprocess"].CLIP_MEAN
        std = port["preprocess"].CLIP_STD
        t = time.perf_counter()
        make_s = 0.0
        chunks = large_class_chunks(torch, np, rng, mean, std, n_large)
        while True:
            tm = time.perf_counter()
            item = next(chunks, None)
            make_s += time.perf_counter() - tm
            if item is None:
                break
            lo, crops = item
            paths = [f"/augmented/class0/{i}.png"
                     for i in range(lo, lo + len(crops))]
            embed.embed_arrays(gallery, encoder, crops, paths,
                               ["class0"] * len(crops), is_augmented=True,
                               batch_size=64)
            batches += math.ceil(len(crops) / 64)
        out["large_class_s"] = time.perf_counter() - t
        out["large_class_make_crops_s"] = make_s
        out["large_class_embed_arrays_crops_per_s"] = \
            n_large / (out["large_class_s"] - make_s)
        if len(gallery) != n_tree + n_large:
            raise AssertionError(f"{len(gallery)} points")

        t = time.perf_counter()
        built = port["delegates"].build_delegates(gallery)
        out["delegates_s"] = time.perf_counter() - t
        large = [k for k, v in built.member_counts.items()
                 if v > port["delegates"].LARGE_CLASS_THRESHOLD]
        groups = sum(v > 0 for v in built.member_counts.values())
        if large != [("class0", "pre_c", "original_images")] or \
                built.n_delegates_written != 4 * groups:
            raise AssertionError(f"delegates: {built}")

        # The large class's medoid against the plain sums on the card.
        Filter = port["schema"].Filter
        members = gallery.vectors_matching(
            Filter(must={"class_name": "class0", "is_delegate": False,
                         "data_type": "original_images"})
            & Filter.for_case("pre_c"))
        medoid = gallery.scroll_all(Filter(must={
            "class_name": "class0", "delegate_type": "medoid",
            "is_augmented": True}), with_vectors=True)[0].vector
        row = int(np.flatnonzero((members == medoid).all(axis=1))[0])
        plain = M.pairwise_distance_sums_plain(torch.from_numpy(members)
                                               .cuda())
        if not medoid_agrees(row, plain):
            raise AssertionError("large-class medoid is not the plain one")
        out["large_class_medoid_row"] = row
        out["large_class_plain_argmin"] = int(plain.argmin())

        t = time.perf_counter()
        runs = {}
        for mode in ("same_class", "nearest"):
            runs[mode] = xp.run_experiments(gallery, xp.ExperimentConfig(
                root_dir=str(root / "dataset_segmented"),
                results_dir=str(root / "results" / mode), match_mode=mode))
        out["experiments_s"] = time.perf_counter() - t
        n_test = 8 * len(COLORS)  # natural images of the test group
        for mode, res in runs.items():
            # pre_a and pre_b have natural delegates; pre_c has none.
            if len(res.rows) != n_test * 2 * 4:
                raise AssertionError(f"{mode}: {len(res.rows)} rows")
            with open(res.csv_path) as f:
                header = next(csv.reader(f))
            if header != ["experiment_id", "case", "delegate_type",
                          "image_path", "true_class", "predicted_class",
                          "similarity_score"]:
                raise AssertionError(f"csv header {header}")
            names = sorted(p.name for p in (res.csv_path.parent /
                                            "score_distribution").iterdir())
            if names != sorted(f"{c}_{d}_scores.npy" for c in ("pre_a",
                                                               "pre_b")
                               for d in ("average", "centroid", "medoid",
                                         "weighted")):
                raise AssertionError(f"npy names {names}")
            if not all(math.isfinite(r.similarity_score)
                       and -1.0 <= r.similarity_score <= 1.0 + 1e-6
                       for r in res.rows):
                raise AssertionError(f"{mode}: bad scores")
        if not all(r.predicted_class == r.true_class
                   for r in runs["same_class"].rows):
            raise AssertionError("same_class predicted != true")
        nearest = runs["nearest"].rows
        out["nearest_top1"] = (sum(r.predicted_class == r.true_class
                                   for r in nearest) / len(nearest))
        out["result_rows"] = len(runs["same_class"].rows)
    out.update(points=len(gallery), encode_batches=batches,
               timing_encodes=timing_encodes,
               delegates=built.n_delegates_written, groups_over_threshold=
               len(large), seconds=time.perf_counter() - t0)
    log("experiment_path", **out)
    return out


def gallery_int4_phase(torch, np, port, gallery, queries, picks) -> dict:
    """search(method="int4") on the 1M-row gallery of the int8 phase:
    through B3, the same ids as the plain int4 path over the same mirrors,
    and its top-10 overlap with exact search."""
    S4 = port["int4_scan"]
    search_lib = port["search"]
    k = 10
    before = S4.KERNEL.launches
    t = time.perf_counter()
    hits = gallery.search(queries, k=k, method="int4")
    first_ms = (time.perf_counter() - t) * 1e3
    if S4.KERNEL.launches == before or gallery._dev_int4 is None:
        raise AssertionError("method='int4' did not launch the int4 scan")
    packed, scales = gallery._dev_int4
    flt = port["schema"].Filter(must={"class_name": "c3"})
    fhits = gallery.search(queries, k=k, flt=flt, method="int4")
    q = torch.from_numpy(queries).cuda()
    rescore = min(max(8 * k, 256), gallery._padded)
    for f, res in ((None, hits), (flt, fhits)):
        _, idx = search_lib.int4_cosine_topk(
            q, packed, scales, gallery._dev_f32, gallery._device_mask(f),
            k=k, rescore=rescore)
        for got, rows in zip(res, idx.cpu().numpy()):
            if {h.id for h in got} != {gallery._ids[r] for r in rows}:
                raise AssertionError("int4 ids differ from the plain path")
    if any(h.payload.class_name != "c3" for res in fhits for h in res):
        raise AssertionError("filtered int4 hits outside c3")
    exact = gallery.search(queries, k=k, method="exact")
    overlap = float(np.mean([len({h.id for h in a} & {h.id for h in e}) / k
                             for a, e in zip(hits, exact)]))
    steady = []
    for _ in range(5):
        t = time.perf_counter()
        gallery.search(queries, k=k, method="int4")
        steady.append((time.perf_counter() - t) * 1e3)
    self_hits = sum(int(f"row-{p}" == a[0].id) for p, a in zip(picks, hits))
    if self_hits != len(picks):
        raise AssertionError(f"int4 self hits {self_hits}/{len(picks)}")
    out = {"rows": len(gallery), "queries": len(queries), "k": k,
           "rescore": rescore, "first_search_ms_host_clock": first_ms,
           "search_ms_host_clock": sorted(steady),
           "top10_overlap_with_exact": overlap,
           "ids_equal_plain_int4": True,
           "self_hit_top1": f"{self_hits}/{len(picks)}"}
    log("gallery_int4_search", **out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        import numpy as np
        import torch
        import torch.nn.functional as F

        from retrieval_based_object_detection_tpu_torch.gallery import (
            schema, search, store,
        )
        from retrieval_based_object_detection_tpu_torch.models.clip import (
            model as clip_model, preprocess,
        )
        from retrieval_based_object_detection_tpu_torch.models.detector import (
            saliency,
        )
        from retrieval_based_object_detection_tpu_torch.ops import (
            clip_attention as CA, cuda_lib, image, int4_scan as S4,
            int8_scan as S, medoid as M,
        )
        from retrieval_based_object_detection_tpu_torch.pipelines import (
            delegates, embed, experiments, serve,
        )
        from retrieval_based_object_detection_tpu_torch.utils import (
            loader, tree,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script measures the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    port = {"schema": schema, "store": store, "clip_model": clip_model,
            "preprocess": preprocess, "int8_scan": S, "delegates": delegates,
            "embed": embed, "serve": serve, "saliency": saliency,
            "image": image, "int4_scan": S4, "medoid": M,
            "experiments": experiments, "search": search, "tree": tree,
            "loader": loader}

    # Full f32 on the card: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t = time.perf_counter()
    libraries = [CA.KERNEL, S.KERNEL, S4.KERNEL, M.KERNEL]
    cuda_lib.build_all(libraries)
    log("build", seconds=time.perf_counter() - t,
        libraries=[lib.path.name for lib in libraries])

    attn = attention_phase(torch, F, CA, args.seed)
    scan = scan_phase(torch, S, args.seed)
    torch.cuda.empty_cache()
    int4 = int4_phase(torch, S4, args.seed)
    torch.cuda.empty_cache()
    med = medoid_phase(torch, M, args.seed)
    torch.cuda.empty_cache()

    def zero_counts():
        for lib in libraries:
            lib.launches = 0

    def read_counts():
        return {"attn": CA.KERNEL.launches, "scan": S.KERNEL.launches,
                "int4": S4.KERNEL.launches, "medoid": M.KERNEL.launches}

    # The serving path: launch counts from here to its end only.
    zero_counts()
    serving, detector, params = serving_phase(torch, np, port, args.seed)
    _, big, queries, picks = gallery_phase(torch, np, port, args.seed)
    launches = read_counts()
    encodes = serving["embed_batches"] + serving["dispatches"]
    if launches["attn"] < 12 * encodes or launches["scan"] < 1:
        raise AssertionError(f"kernel launches {launches} for {encodes} "
                             "encodes and the int8 searches")
    breakdown_phase(torch, np, port, detector, args.seed)
    del detector

    # The offline path: launch counts from here to its end only.
    zero_counts()
    offline = experiment_phase(torch, np, port, params, args.seed)
    gallery_int4_phase(torch, np, port, big, queries, picks)
    offline_launches = read_counts()
    encodes = offline["encode_batches"] + offline["timing_encodes"]
    if offline_launches["attn"] != 12 * encodes or \
            offline_launches["medoid"] != offline["groups_over_threshold"] \
            or offline_launches["int4"] < 1:
        raise AssertionError(
            f"offline kernel launches {offline_launches} for {encodes} "
            "encodes, "
            f"{offline['groups_over_threshold']} large groups and the int4 "
            "searches")
    del big
    by_path = {k: {"serving": launches[k], "offline": offline_launches[k]}
               for k in launches}

    def row(name, source, replaces, key, res, shape, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": launches[key] + offline_launches[key],
                "launches_by_path": by_path[key],
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": res["library_ms"],
                "shape": shape, **extra}

    bf16 = attn["bfloat16"]
    f32 = attn["float32"]
    kernels = [
        row("clip_attention_fwd", ATTN_SOURCE, ATTN_REPLACES, "attn", bf16,
            [64, 50, 2304], dtype="bfloat16",
            float32={k: f32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}),
        row("int8_scan", SCAN_SOURCE, SCAN_REPLACES, "scan", scan,
            [16, 1 << 20, 512]),
        row("int4_scan", INT4_SOURCE, INT4_REPLACES, "int4", int4,
            [16, 1 << 20, 512]),
        row("medoid_sums", MEDOID_SOURCE, MEDOID_REPLACES, "medoid", med,
            [12_000, 512]),
    ]
    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
