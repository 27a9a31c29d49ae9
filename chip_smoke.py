#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: its serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from ``csrc/`` (one nvcc per source, all
started together), holds each against its plain PyTorch version at the
serving path's shapes, then drives the serving path through the calls a
user makes: a full-width CLIP ViT-B/32 from seeded weights embeds a few
hundred synthetic crops into a Gallery, ``build_delegates`` runs, and
``serve_http`` answers concurrent ``POST /detect`` requests; a 1,048,576 x
512 gallery then answers ``Gallery.search(exact=False)`` through the int8
scan. Kernel launch counters are zeroed just before that path and read
just after it.

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
    return out, detector


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
            schema, store,
        )
        from retrieval_based_object_detection_tpu_torch.models.clip import (
            model as clip_model, preprocess,
        )
        from retrieval_based_object_detection_tpu_torch.models.detector import (
            saliency,
        )
        from retrieval_based_object_detection_tpu_torch.ops import (
            clip_attention as CA, cuda_lib, image, int8_scan as S,
        )
        from retrieval_based_object_detection_tpu_torch.pipelines import (
            delegates, embed, serve,
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
            "image": image}

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
    cuda_lib.build_all([CA.KERNEL, S.KERNEL])
    log("build", seconds=time.perf_counter() - t,
        libraries=[CA.KERNEL.path.name, S.KERNEL.path.name])

    attn = attention_phase(torch, F, CA, args.seed)
    scan = scan_phase(torch, S, args.seed)
    torch.cuda.empty_cache()

    # The serving path: launch counts from here to its end only.
    CA.KERNEL.launches = 0
    S.KERNEL.launches = 0
    serving, detector = serving_phase(torch, np, port, args.seed)
    gallery_phase(torch, np, port, args.seed)
    launches = {"attn": CA.KERNEL.launches, "scan": S.KERNEL.launches}
    encodes = serving["embed_batches"] + serving["dispatches"]
    if launches["attn"] < 12 * encodes or launches["scan"] < 1:
        raise AssertionError(f"kernel launches {launches} for {encodes} "
                             "encodes and the int8 searches")
    breakdown_phase(torch, np, port, detector, args.seed)

    bf16 = attn["bfloat16"]
    f32 = attn["float32"]
    kernels = [
        {"name": "clip_attention_fwd", "route": "cuda",
         "source": ATTN_SOURCE, "replaces": ATTN_REPLACES,
         "launches": launches["attn"], "max_abs_err": bf16["max_abs_err"],
         "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
         "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
         "library_ms": bf16["library_ms"], "dtype": "bfloat16",
         "shape": [64, 50, 2304],
         "float32": {k: f32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}},
        {"name": "int8_scan", "route": "cuda",
         "source": SCAN_SOURCE, "replaces": SCAN_REPLACES,
         "launches": launches["scan"], "max_abs_err": scan["max_abs_err"],
         "ms": scan["ms"], "plain_ms": scan["plain_ms"],
         "bound_ms": scan["bound_ms"], "bound_by": scan["bound_by"],
         "library_ms": scan["library_ms"], "shape": [16, 1 << 20, 512]},
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
