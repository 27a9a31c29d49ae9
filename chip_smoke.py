#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: its serving, detection, offline,
gallery, service, sharded, training, mesh_training, segment and cli paths
on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from ``csrc/`` (one nvcc per source, all
started together), counts the tensor-core instructions of each
tensor-core kernel (B1–B7), and holds each kernel against its
plain PyTorch version at the shapes its path gives it. Then it drives
ten paths through the calls a user makes, at full width from seeded
weights:

- serving: a few hundred synthetic crops are embedded into a Gallery,
  ``build_delegates`` runs, ``serve_http`` answers concurrent
  ``POST /detect`` requests, and a 1,048,576 x 512 gallery answers
  ``Gallery.search(exact=False)`` through the int8 scan;
- offline: ``embed_tree`` over a synthetic dataset tree, 12,000 crops of
  one class through ``embed_arrays`` (a group past the blocked-medoid
  threshold), ``build_delegates``, ``run_experiments`` in both match
  modes writing CSV/npy, ``analyze`` of both result CSVs, and
  ``search(method="int4")`` on the 1M-row gallery;
- gallery: the 1M-row gallery as a database — 1% of its rows deleted by
  filter and 1,000 by id, searched through exact, int8 and int4 against
  an exact search over the live rows, compacted; saved as a ``.rbod``
  snapshot with a delta and reloaded (identical hits); searched through
  the capacity tier; then the capacity view at 10,485,760 x 512 from
  planes made on the card (the int4 scan past 2^31 bytes of packed rows),
  with a filter and 1% of rows deleted, against an exact cosine over the
  same bf16 rows;
- service: the compacted 1M-row gallery saved as a ``.rbod`` root and
  served by ``gallery.server.serve(warm=True)``, with a copy behind the
  Qdrant façade; ``GalleryClient`` searches through the exact, int8 (B2)
  and int4 (B3) tiers equal to the in-process ones, a binary upsert and
  deletes against an exact search over the live rows, retrieve / by-path /
  scroll / count, 8 reader threads against a writer and the serial oracle,
  ``/snapshot`` and a reload, the façade's raw REST calls and
  ``migrate.import_qdrant``, and two shard servers behind ``serve_router``
  equal to the single server;
- sharded: ``attach_mesh`` of a 4-shard mesh listing cuda:0 four times
  (B2 or B3 once per shard per search), each tier against the
  single-device one, writes that patch the view, and
  ``serve(mesh_devices=-1)``;
- training: ``fit`` fine-tunes ViT-B/32 (bf16 compute, f32 weights) for 12
  steps of 64 on a colour-class tree with checkpoints, then resumes for 6
  more under the cosine schedule; one f32 step's gradients are held
  against the plain attention core on the card;
- mesh_training: ``fit`` on a dp 2 × tp 2 mesh listing cuda:0 four times
  (the single controller's loop on one card, not a collective), ViT-B/32
  in bf16, global batch 64, one epoch with a checkpoint, then one epoch
  resumed from it on one device; B1 and B5 once per dp shard and block;
  ``make_sharded_encoder`` on dp = 2; one f32 step's gradients on the mesh
  against the one-device step, and the sharded encoder against
  ``make_encoder``;
- segment: SAM-B (1024 px) ``run_auto_segment`` over a small tree with a
  file that does not decode, then ``set_image`` and ``predict``; the
  encoder is held against its einsum attention (f32 and bf16) and
  ``segment_batch``
  against per-image ``predict`` on the card;
- detection (the front of the pipeline, run after the serving path):
  ``run_ingest`` of 192 product photos of 480 x 640 (a camera duplicate
  and a file that does not decode beside them); YOLOv8s at 640 from
  seeded weights, its heads and decode against the same module in
  float64 (TF32 off and on), ``predict`` and ``postprocess`` timed,
  ``run_labeling`` over a copy of the tree; ``run_labeling`` with the
  saliency proposer (labels against the known product boxes);
  ``run_crop``; ``run_augment`` on 8 crops, the deterministic ops equal
  to the CPU's; ``fit_detector`` of the default TinyDet and its boxes on
  held-out photos; ``embed_tree`` of the crops and a
  ``RetrievalDetector`` answering 8 ``detect`` calls with TinyDet as its
  external detector;
- cli (the port's own program, run last): every command through the
  port CLI's ``main([...])`` in this process, on the default device —
  ``convert-weights`` of seeded official-layout ViT-B/32 (with its text
  tower's keys) and SAM-B files (the SAM-B upscaling biases nonzero, and
  kept by the conversion); ``e2e --raw`` over 4 classes x (8
  original + 4 natural) product photos of 480 x 640 (ingest, saliency
  labels held to the known boxes at IoU 0.5, crop, SAM-B segment,
  augment, ViT-B/32 embed, delegates, experiments, analyze); ``fit-sam``
  from the converted SAM-B (batch 2, one epoch) and ``segment`` from what
  it wrote; ``finetune`` (bf16, ``--dp 1 --tp 1``) and ``embed`` from
  what it wrote, and ``finetune`` on more cards than there are (the
  device-count error, exit 2);
  ``serve`` answering 3 ``/detect`` requests; ``segment-web`` (a click, a
  save, a next); ``review`` and ``restore``; ``store``; and ``doctor`` as
  ``python -m retrieval_based_object_detection_tpu_torch.cli`` in a
  subprocess. Each command's seconds and launches of B1, B5 and B6.

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
# Dense peaks (NVIDIA data sheet). f32: the card's fastest f32-accurate
# product, 3xTF32 on the tensor cores (three TF32 products at 495 TFLOP/s
# for one f32 product); f32 on the CUDA cores runs at 67 TFLOP/s.
F32_CUDA_CORE_OPS = 67e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 495e12 / 3, "int8": 1979e12}

ATTN_SOURCE = "retrieval_based_object_detection_tpu_torch/csrc/clip_attention.cu"
ATTN_REPLACES = "retrieval_based_object_detection_tpu/ops/clip_attention.py:30"
SCAN_SOURCE = "retrieval_based_object_detection_tpu_torch/csrc/int8_scan.cu"
SCAN_REPLACES = "retrieval_based_object_detection_tpu/ops/int8_scan.py:59"
INT4_SOURCE = "retrieval_based_object_detection_tpu_torch/csrc/int4_scan.cu"
INT4_REPLACES = "retrieval_based_object_detection_tpu/ops/int4_scan.py:80"
MEDOID_SOURCE = "retrieval_based_object_detection_tpu_torch/csrc/medoid.cu"
MEDOID_REPLACES = "retrieval_based_object_detection_tpu/ops/medoid.py:23"
MEDOID_RTOL, MEDOID_ATOL = 1e-4, 5e-2  # tests/test_pallas_medoid.py
BWD_REPLACES = "retrieval_based_object_detection_tpu/ops/clip_attention.py:50"
FLASH_SOURCE = "retrieval_based_object_detection_tpu_torch/csrc/attention.cu"
FLASH2D_REPLACES = "retrieval_based_object_detection_tpu/ops/attention.py:106"
FLASH_REPLACES = "retrieval_based_object_detection_tpu/ops/attention.py:25"
# B5 against the plain backward: f32 at the JAX package's custom-VJP
# tolerance (tests/test_clip_fused_attention.py); bf16 both sides compute in
# f32 and round once at the store, so one bf16 ulp apart at most.
BWD_TOLS = {"bfloat16": (1e-3, 2 ** -7), "float32": (2e-4, 1e-4)}
# B6/B7 against the plain oracle: f32, the same f32 sums in another order
# over up to 4,096 keys; bf16, the kernel rounds each unnormalised p to bf16
# before PV (as the Pallas kernel does) where the oracle keeps p in f32, at
# most 2^-9 of the largest |v|, plus one bf16 ulp of the output.
FLASH_TOLS = {"bfloat16": (1e-2, 2 ** -7), "float32": (1e-4, 1e-5)}

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


def cuda_graph_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of one call from one replay of a CUDA graph that
    holds ``reps`` calls: for kernels of a few microseconds, where the host
    cannot start eager calls as fast as the card runs them and events around
    eager calls time the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(torch, fn, reps: int = 20) -> tuple[float, float]:
    """(device time in ms, device operations) of one call as
    ``torch.profiler`` sums the kernels and copies of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if not events:
        raise AssertionError("the profiler recorded no device time")
    return (sum(e.self_device_time_total for e in events) / reps / 1e3,
            sum(e.count for e in events) / reps)


def profiler_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call by the profiler: for work that a CUDA graph
    cannot capture (autograd's backward runs on its own thread) and that is
    shorter than the host's cost of calling it."""
    return device_profile(torch, fn, reps)[0]


# The tensor-core kernels of each library, by their mangled names, with the
# number of instantiations and the instruction to count: the flash kernels
# (B6/B7: f32 and bf16 x head width 32/64/128 x bias), the attention core's
# forward and backward (B1, B5: f32 and bf16 x head width 32/64/128), the
# medoid's tile kernel (B4) and the int8 and int4 scans (B2, B3, on the int8
# tensor cores).
TENSOR_CORE_KERNELS = {
    "attention": [
        ("flash_fwd", r"flash_fwdI(13__nv_bfloat16|f)Li(\d+)ELb([01])E", 12,
         "HMMA")],
    "clip_attention": [
        ("attn_core_fwd", r"attn_core_fwdI(13__nv_bfloat16|f)Li(\d+)E", 6,
         "HMMA"),
        ("attn_core_bwd", r"attn_core_bwdI(13__nv_bfloat16|f)Li(\d+)E", 6,
         "HMMA")],
    "medoid": [("tile_sums", "tile_sums", 1, "HMMA")],
    "int4_scan": [("scan", "4scanE", 1, "IMMA")],
    "int8_scan": [("scan", "4scanE", 1, "IMMA")],
}


def hmma_phase(libraries) -> dict:
    """Tensor-core instructions in each tensor-core kernel of the built
    libraries, from ``cuobjdump -sass``: HMMA (which is also what mma.sync on
    TF32 compiles to) or, for the int8 product, IMMA. Every instantiation
    must have some."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for lib in libraries:
        sass = subprocess.run([tool, "-sass", str(lib.path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts = {}
        for kernel, mangled, expected, instr in TENSOR_CORE_KERNELS[lib.name]:
            found, name = {}, None
            for line in sass.splitlines():
                fn = re.search(r"Function : (\S+)", line)
                if fn:
                    kind = re.search(mangled, fn.group(1))
                    name = None
                    if kind:
                        g = kind.groups()
                        args = ["bf16" if g[0] != "f" else "f32", g[1]] + \
                            [["no bias", "bias"][int(b)] for b in g[2:]] \
                            if g else []
                        name = kernel + \
                            (f"<{', '.join(args)}>" if args else "")
                        found[name] = 0
                elif name and instr in line:
                    found[name] += 1
            if len(found) != expected or not all(found.values()):
                raise AssertionError(
                    f"{instr} counts per {kernel} kernel of {lib.path.name}: "
                    f"{found}")
            counts.update(found)
        log("hmma", library=lib.path.name, tensor_core_instructions=counts)
        out[lib.name] = counts
    return out


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
        # The kernel and SDPA take 15 to 40 us, less than the host needs
        # to start one eager call: ms, plain_ms and library_ms are device
        # times from a CUDA graph's replay; the eager_ms beside them are
        # events around 20 eager calls, as the other kernels are timed.
        out[name] = {
            "max_abs_err": err, "atol": atol, "rtol": rtol,
            "ms": cuda_graph_ms(
                torch, lambda: CA.clip_attention_core(qkv, H)),
            "plain_ms": cuda_graph_ms(
                torch, lambda: CA.clip_attention_core_plain(qkv, H)),
            "library_ms": cuda_graph_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v)),
            "eager_ms": cuda_ms(
                torch, lambda: CA.clip_attention_core(qkv, H)),
            "library_eager_ms": cuda_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    log("attention_kernel_vs_plain", shape=[B, T, 3 * W], **out)
    return out


BWD_SHAPE = (64, 50, 12, 64)  # B, T, heads, head dim of a training step


def attention_bwd_inputs(torch, seed: int):
    """Seeded qkv [64, 50, 2304] and dO [64, 50, 768] in f32 on the card."""
    B, T, H, D = BWD_SHAPE
    g = torch.Generator(device="cpu").manual_seed(seed + 8)
    return (torch.randn(B, T, 3 * H * D, generator=g).cuda(),
            torch.randn(B, T, H * D, generator=g).cuda())


def attention_bwd_float64(torch, qkv, dout, heads):
    """The backward's formulas in float64 on the inputs' values."""
    B, T, W3 = qkv.shape
    W = W3 // 3
    D = W // heads
    q, k, v = (t.double().view(B, T, heads, D).transpose(1, 2)
               for t in qkv.split(W, dim=-1))
    g = dout.double().view(B, T, heads, D).transpose(1, 2)
    p = torch.softmax(q @ k.transpose(-1, -2) * D ** -0.5, dim=-1)
    dp = g @ v.transpose(-1, -2)
    dl = p * (dp - (dp * p).sum(-1, keepdim=True))
    parts = (dl @ k * D ** -0.5, dl.transpose(-1, -2) @ q * D ** -0.5,
             p.transpose(-1, -2) @ g)
    return torch.cat([t.transpose(1, 2).reshape(B, T, W) for t in parts],
                     dim=-1)


def attention_bwd_phase(torch, CA, seed: int) -> dict:
    """B5 against its plain version at the training shape [64, 50, 2304]
    with the output gradient [64, 50, 768], bf16 and f32, and both against
    float64, also with the logits scaled x30 (q * 30: rows close to
    one-hot)."""
    B, T, H, D = BWD_SHAPE
    W = H * D
    base, dbase = attention_bwd_inputs(torch, seed)
    large = base.clone()
    large[..., :W] *= 30
    out = {}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        qkv, dout = base.to(dtype), dbase.to(dtype)
        got = CA.clip_attention_core_bwd(qkv, dout, H)
        torch.cuda.synchronize()
        want = CA.clip_attention_core_bwd_plain(qkv, dout, H)
        atol, rtol = BWD_TOLS[name]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        if not torch.equal(CA.clip_attention_core_bwd(qkv, dout, H), got):
            raise AssertionError("attention backward differs between runs")
        ref = attention_bwd_float64(torch, qkv, dout, H)
        err64 = float((got.double() - ref).abs().max())
        plain_err64 = float((want.double() - ref).abs().max())
        # Logits x30: held to float64, no farther from it than twice the
        # plain version plus the tolerance's absolute part (times 3: dk
        # grows with q).
        big = large.to(dtype)
        got_big = CA.clip_attention_core_bwd(big, dout, H)
        ref_big = attention_bwd_float64(torch, big, dout, H)
        big_err64 = float((got_big.double() - ref_big).abs().max())
        big_plain_err64 = float((CA.clip_attention_core_bwd_plain(
            big, dout, H).double() - ref_big).abs().max())
        if not bool(torch.isfinite(got_big.float()).all()) or \
                err64 > 2 * plain_err64 + atol or \
                big_err64 > 2 * big_plain_err64 + 3 * atol:
            raise AssertionError(
                f"attention backward against float64 ({name}): kernel "
                f"{err64}, plain {plain_err64}; logits x30: kernel "
                f"{big_err64}, plain {big_plain_err64}")
        del big, got_big, ref_big, ref
        size = qkv.element_size()
        # qkv and dO read once, dqkv written once; the logits and the four
        # other products the formulas need (2 T^2 D each) and ~10 per logit
        # for the softmax and dl.
        n_bytes = B * T * (3 * W + W + 3 * W) * size
        n_ops = B * H * (10 * T * T * D + 10 * T * T)
        b_ms, b_by = bound_ms(n_bytes, n_ops, name)
        # As B1: the kernel is shorter than the host's cost of an eager
        # call, so ms and plain_ms are device times from a CUDA graph's
        # replay; the eager_ms beside them are events around 20 eager
        # calls. library_ms comes from attention_bwd_library_phase.
        out[name] = {
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "atol": atol, "rtol": rtol,
            "err_vs_float64": err64, "plain_err_vs_float64": plain_err64,
            "large_logits_err_vs_float64": big_err64,
            "large_logits_plain_err_vs_float64": big_plain_err64,
            "ms": cuda_graph_ms(torch, lambda: CA.clip_attention_core_bwd(
                qkv, dout, H)),
            "plain_ms": cuda_graph_ms(
                torch, lambda: CA.clip_attention_core_bwd_plain(qkv, dout, H)),
            "eager_ms": cuda_ms(torch, lambda: CA.clip_attention_core_bwd(
                qkv, dout, H)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    log("attention_bwd_kernel_vs_plain", shape=[B, T, 3 * W], **out)
    return out


def attention_bwd_library_phase(torch, F, CA, seed: int, out: dict) -> None:
    """B5's library yardstick, added to ``out``: the backward alone of SDPA
    on the split q, k, v at the training shape. Autograd's backward cannot
    be captured in a CUDA graph, so library_ms is the profiler's device
    time of its kernels, and profiler_ms the kernel's own time taken the
    same way. It runs after every path, so that nothing the profiler may
    leave attached to the process can touch the paths' host-side times."""
    B, T, H, D = BWD_SHAPE
    W = H * D
    base, dbase = attention_bwd_inputs(torch, seed)
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        qkv, dout = base.to(dtype), dbase.to(dtype)
        x = qkv.clone().requires_grad_(True)
        q, k, v = (t.view(B, T, H, D).transpose(1, 2)
                   for t in x.split(W, dim=-1))
        sdpa = F.scaled_dot_product_attention(q, k, v)
        d_heads = dout.view(B, T, H, D).transpose(1, 2)

        def library():
            return torch.autograd.grad(sdpa, (q, k, v), d_heads,
                                       retain_graph=True)
        out[name].update(
            library_eager_ms=cuda_ms(torch, library),
            library_ms=profiler_ms(torch, library),
            profiler_ms=profiler_ms(
                torch, lambda: CA.clip_attention_core_bwd(qkv, dout, H)))
    log("attention_bwd_library", shape=[B, T, 3 * W], **{
        name: {k: out[name][k] for k in (
            "ms", "profiler_ms", "library_ms", "library_eager_ms")}
        for name in out})


def flash_phase(torch, F, A, seed: int) -> dict:
    """B6 at SAM-B's global shape [4, 12, 4096, 64] (grid 64 x 64) and its
    windowed shape [100, 12, 196, 64] (14 x 14 windows of 4 images), and B7
    at [4, 12, 4096, 64], each in f32 and bf16 against its plain version.
    Yardsticks: SDPA with the bias expanded to a float attn_mask
    [B, H, T, T] (B6; 3.2 GB in f32 at the global shape, 805 MB per image,
    half that in bf16, which SDPA needs for a bf16 query), SDPA with no
    mask (B7)."""
    g = torch.Generator(device="cpu").manual_seed(seed + 9)
    out = {}
    for case, (B, H, gh, gw, D, bias) in {
            "b6_global": (4, 12, 64, 64, 64, True),
            "b6_windowed": (100, 12, 14, 14, 64, True),
            "b7": (4, 12, 64, 64, 64, False)}.items():
        T = gh * gw
        q0, k0, v0 = (torch.randn(B, H, T, D, generator=g).cuda()
                      for _ in range(3))
        bh = torch.randn(B, H, T, gh, generator=g).cuda()
        bw = torch.randn(B, H, T, gw, generator=g).cuda()
        res = {}
        for name, dtype in (("bfloat16", torch.bfloat16),
                            ("float32", torch.float32)):
            q, k, v = q0.to(dtype), k0.to(dtype), v0.to(dtype)
            if bias:
                def kernel():
                    return A.flash_attention_2d_bias(q, k, v, bh, bw, gh, gw)

                def plain():
                    return A.flash_attention_2d_bias_plain(q, k, v, bh, bw,
                                                           gh, gw)
                mask = (bh[..., :, None] + bw[..., None, :]).reshape(
                    B, H, T, T).to(dtype)

                def library():
                    return F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask)
            else:
                def kernel():
                    return A.flash_attention(q, k, v)

                def plain():
                    return A.flash_attention_plain(q, k, v)

                def library():
                    return F.scaled_dot_product_attention(q, k, v)
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            atol, rtol = FLASH_TOLS[name]
            torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                       rtol=rtol)
            size = q.element_size()
            # q, k, v read and o written once, plus the two f32 bias
            # tables; 4 T^2 Dh per (image, head) for QK^T and PV, and the
            # two bias adds per logit.
            n_bytes = 4 * B * H * T * D * size + \
                (4 * B * H * T * (gh + gw) if bias else 0)
            n_ops = B * H * (4 * T * T * D + (2 * T * T if bias else 0))
            b_ms, b_by = bound_ms(n_bytes, n_ops, name)
            big = T > 1024
            res[name] = {
                "max_abs_err": float((got.float() - want.float()).abs().max()),
                "atol": atol, "rtol": rtol,
                "ms": cuda_ms(torch, kernel, reps=5 if big else 20),
                "plain_ms": cuda_ms(torch, plain, reps=3 if big else 20,
                                    warmup=1),
                "library_ms": cuda_ms(torch, library, reps=5 if big else 20),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            del got, want
            if bias:
                del mask
            torch.cuda.empty_cache()
        out[case] = {"shape": [B, H, T, D], **res}
        log(f"{case}_kernel_vs_plain", grid=[gh, gw], **out[case])
    return out


def int_mm_yardstick(torch, q, rows, pen, want, reps: int = 20) -> dict:
    """B2's yardstick: ``torch._int_mm(rows, q.t())``, the int8 tensor-core
    product through cuBLASLt that computes B2's dots in exact int32 (the
    gallery rows are its first operand: its CUDA path takes more than 16
    rows and sizes that are multiples of 8), and the composite that writes
    B2's whole function, ``_int_mm`` → ``.t()`` → ``+ penalty`` into a
    [Q, N] f32 tensor. The composite is held bit for bit against the plain
    scan ``want``."""
    q_t = q.t()
    out = torch.empty(q.shape[0], rows.shape[0], device=q.device)

    def full():
        return torch.add(torch._int_mm(rows, q_t).t(), pen, out=out)

    full()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(
            "_int_mm → .t() → + penalty differs from the plain scan: max abs "
            f"err {float((out - want).abs().max())}")
    return {"library": "torch._int_mm",
            "library_ms": cuda_ms(torch, lambda: torch._int_mm(rows, q_t),
                                  reps=reps),
            "library_full_ms": cuda_ms(torch, full, reps=reps)}


def scan_phase(torch, S, seed: int) -> dict:
    """B2 against its plain version at Q=16 x N=1,048,576 x 512, bit-exact,
    timed beside ``torch._int_mm`` (alone and as the composite that writes
    B2's scores) and, for continuity, a bf16 matmul of the same rows."""
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
    del got
    yardstick = int_mm_yardstick(torch, q, rows, pen, want)
    del want
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
        **yardstick,
        "bf16_matmul_ms": cuda_ms(torch, lambda: q_bf16 @ rows_bf16.T),
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


def medoid_near_duplicates(torch, M, seed: int) -> dict:
    """B4 on a class of jittered crops: 3,000 rows, one unit centre plus
    1e-3 noise, 512-d, so d² is a difference of nearly equal numbers.
    Against float64 direct distances the kernel must be within the medoid
    tolerance and pick a member as good as the plain version's."""
    N, D = 3_000, 512
    g = torch.Generator(device="cpu").manual_seed(seed + 15)
    centre = torch.nn.functional.normalize(
        torch.randn(D, generator=g, dtype=torch.float64), dim=0)
    x = (centre + 1e-3 * torch.randn(N, D, generator=g, dtype=torch.float64)
         ).float().cuda()
    ref = torch.cdist(x.double(), x.double(),
                      compute_mode="donot_use_mm_for_euclid_dist").sum(1)
    got = M.pairwise_distance_sums(x)
    torch.cuda.synchronize()
    plain = M.pairwise_distance_sums_plain(x)
    best = float(ref.min())
    out = {
        "shape": [N, D], "tol": MEDOID_ATOL + MEDOID_RTOL * best,
        "err_vs_float64": float((got.double() - ref).abs().max()),
        "plain_err_vs_float64": float((plain.double() - ref).abs().max()),
        "argmin_gap": float(ref[got.argmin()]) - best,
        "plain_argmin_gap": float(ref[plain.argmin()]) - best,
    }
    if out["err_vs_float64"] > out["tol"] or \
            out["argmin_gap"] > out["plain_argmin_gap"] + 1e-3:
        raise AssertionError(f"medoid kernel on near-duplicate rows: {out}")
    return out


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
    near = medoid_near_duplicates(torch, M, seed)
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
        "bound_ms": b_ms, "bound_by": b_by, "near_duplicates": near,
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
    # Every 100th row is a natural image: 1% of the gallery, the rows the
    # tombstone phase deletes by filter.
    pls = [Payload(data_type=kind, class_name=f"c{i}", img_path="")
           for kind in ("original_images", "natural_images")
           for i in range(8)]
    chunk = 131_072
    for lo in range(0, N, chunk):
        vecs = rng.standard_normal((chunk, D), dtype=np.float32)
        gallery.upsert([f"row-{i}" for i in range(lo, lo + chunk)], vecs,
                       [pls[i % 8 + 8 * (i % 100 == 0)]
                        for i in range(lo, lo + chunk)])
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
        analysis_phase(port, {mode: res.csv_path
                              for mode, res in runs.items()})
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


def host_ms(fn, reps: int = 5) -> list[float]:
    """Sorted host-clock milliseconds of ``reps`` calls."""
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t) * 1e3)
    return sorted(out)


def ids_of(res) -> list[set]:
    return [{h.id for h in r} for r in res]


def live_exact_topk(torch, np, gallery, queries, k: int) -> list[set]:
    """Top-k ids by exact cosine over the gallery's live rows alone, taken
    from its host rows, apart from its mirrors and masks."""
    rows = np.nonzero(gallery._mask_live(None))[0]
    live = torch.from_numpy(gallery._vectors[rows]).cuda()
    live = live / live.norm(dim=1, keepdim=True)
    q = torch.from_numpy(queries).cuda()
    q = q / q.norm(dim=1, keepdim=True)
    idx = torch.topk(q @ live.T, k, dim=1).indices.cpu().numpy()
    return [{gallery._ids[rows[i]] for i in r} for r in idx]


TIERS = ("exact", "int8", "int4")


def tombstones_phase(torch, np, port, gallery, queries, picks,
                     seed: int) -> dict:
    """Deletes on the 1M-row gallery: 1% of its rows by filter (every
    natural image) and 1,000 by id (the first 8 queries' own rows among
    them). The mirrors stay as they are; no deleted id comes back from any
    tier; exact and int8 return the top-10 of an exact search over the
    live rows alone and int4 overlaps it. Then compact and search again."""
    Filter = port["schema"].Filter
    k = 10
    out = {"rows": gallery._nrows, "queries": len(queries), "k": k}
    out["search_ms_host_clock_before"] = {
        t: host_ms(lambda t=t: gallery.search(queries, k=k, method=t), 3)
        for t in TIERS}
    mirrors = (gallery._dev_f32, gallery._dev_int8, gallery._dev_int4[0])
    rng = np.random.default_rng(seed + 30)
    t = time.perf_counter()
    by_filter = gallery.delete(flt=Filter(must={"data_type":
                                                "natural_images"}))
    out["delete_by_filter_ms"] = (time.perf_counter() - t) * 1e3
    gone = {f"row-{i}" for i in range(0, gallery._nrows, 100)}
    own = [int(p) for p in picks[:8] if p % 100]
    pool = np.setdiff1d(np.flatnonzero(np.arange(gallery._nrows) % 100), own)
    others = rng.choice(pool, 1000 - len(own), replace=False)
    by_id = [f"row-{i}" for i in own + [int(i) for i in others]]
    t = time.perf_counter()
    removed = gallery.delete(ids=by_id)
    out["delete_by_id_ms"] = (time.perf_counter() - t) * 1e3
    gone |= set(by_id)
    if by_filter != len(gone) - 1000 or removed != 1000 or \
            len(gallery) != gallery._nrows - len(gone):
        raise AssertionError(f"deleted {by_filter} + {removed} rows")
    after = (gallery._dev_f32, gallery._dev_int8, gallery._dev_int4[0])
    if not all(a is b for a, b in zip(after, mirrors)):
        raise AssertionError("a delete rebuilt a device mirror")
    want = live_exact_topk(torch, np, gallery, queries, k)

    def check(tag):
        res = {t: ids_of(gallery.search(queries, k=k, method=t))
               for t in TIERS}
        if any(gone & ids for r in res.values() for ids in r):
            raise AssertionError(f"{tag}: a deleted id came back")
        for t in ("exact", "int8"):
            if res[t] != want:
                raise AssertionError(f"{tag}: {t} top-10 differs from the "
                                     "exact search over the live rows")
        return float(np.mean([len(a & b) / k
                              for a, b in zip(res["int4"], want)]))

    out["int4_top10_overlap_with_live_exact"] = check("after delete")
    out["deleted"] = len(gone)
    out["search_ms_host_clock_after_delete"] = {
        t: host_ms(lambda t=t: gallery.search(queries, k=k, method=t), 3)
        for t in TIERS}
    t = time.perf_counter()
    out["compacted_rows"] = gallery.compact()
    out["compact_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["int4_top10_overlap_after_compact"] = check("after compact")
    out["first_searches_after_compact_s"] = time.perf_counter() - t
    out["search_ms_host_clock_after_compact"] = {
        t: host_ms(lambda t=t: gallery.search(queries, k=k, method=t), 3)
        for t in TIERS}
    if out["compacted_rows"] != len(gone) or gallery._nrows != len(gallery):
        raise AssertionError(f"compaction reclaimed {out['compacted_rows']}")
    log("tombstones", **out)
    return out


def persist_phase(torch, np, port, gallery, queries) -> dict:
    """save_gallery of the compacted 1M-row gallery, a delete and a delta
    save, load_gallery, and the same searches before and after the reload:
    identical ids and scores. The C++ runtime must have built."""
    import tempfile
    from pathlib import Path

    persist, native = port["persist"], port["native"]
    if not native.available():
        raise AssertionError("the native runtime did not build")
    k = 10
    out = {"rows": len(gallery), "native": str(native.library_path().name)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        persist.save_gallery(gallery, root)
        out["base_write_s"] = time.perf_counter() - t
        out["base_bytes"] = (root / f"{gallery.name}.rbod").stat().st_size
        dead = [gallery._ids[r] for r in range(5, len(gallery), 10_007)]
        gallery.delete(ids=dead)
        t = time.perf_counter()
        persist.save_gallery(gallery, root)
        out["delta_write_ms"] = (time.perf_counter() - t) * 1e3
        out["delta_bytes"] = (root / f"{gallery.name}.rbod.d1").stat(
            ).st_size
        before = {t: gallery.search(queries, k=k, method=t) for t in TIERS}
        t = time.perf_counter()
        loaded = persist.load_gallery(gallery.name, root, device="cuda")
        out["load_s"] = time.perf_counter() - t
        if len(loaded) != len(gallery) or loaded.retrieve(dead[:1]):
            raise AssertionError("the reload lost the delta")
        for tier in TIERS:
            a = [[(h.id, h.score) for h in r] for r in before[tier]]
            b = [[(h.id, h.score) for h in r] for r in loaded.search(
                queries, k=k, method=tier)]
            if a != b:
                raise AssertionError(f"{tier} hits changed across the reload")
        out["deleted_before_delta"] = len(dead)
    del loaded
    torch.cuda.empty_cache()
    log("persist", **out)
    return out


CAPACITY_ROWS = 10_485_760  # the capacity tier's 10M-row configuration


def capacity_phase(torch, np, port, gallery, queries, seed: int):
    """search(method="capacity") through the 1M-row Gallery, then the
    capacity view at 10,485,760 x 512 from planes made on the card chunk by
    chunk (the host holds only the mask): 16 queries, top-10, with a filter
    mask and after a delete of 1% of rows, held against an exact cosine
    over the same bf16 rows taken chunk by chunk."""
    cap, search = port["capacity"], port["search"]
    S4 = port["int4_scan"]
    k, D = 10, 512
    out = {}
    before = S4.KERNEL.launches
    t = time.perf_counter()
    hits = gallery.search(queries, k=k, method="capacity")
    out["gallery_first_capacity_search_s"] = time.perf_counter() - t
    exact = gallery.search(queries, k=k, method="exact")
    out["gallery_capacity_top10_overlap_with_exact"] = float(np.mean(
        [len(a & b) / k for a, b in zip(ids_of(hits), ids_of(exact))]))
    out["gallery_search_ms_host_clock"] = host_ms(
        lambda: gallery.search(queries, k=k, method="capacity"))
    if S4.KERNEL.launches == before or gallery._cap_view is None:
        raise AssertionError("method='capacity' did not launch the int4 scan")
    gallery._cap_view = None  # free its planes before the 10M view
    torch.cuda.empty_cache()

    N, chunk, Q = CAPACITY_ROWS, 262_144, 16
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed + 40)
    bf16 = torch.empty((N, D), dtype=torch.bfloat16, device="cuda")
    packed = torch.empty((N, D // 2), dtype=torch.int8, device="cuda")
    scales = torch.empty(N, dtype=torch.float32, device="cuda")
    for lo in range(0, N, chunk):
        x = torch.randn((chunk, D), generator=g, device="cuda")
        x = x / x.norm(dim=1, keepdim=True)
        p, s = search.pack_rows_int4(x)
        bf16[lo: lo + chunk] = x.to(torch.bfloat16)
        packed[lo: lo + chunk], scales[lo: lo + chunk] = p, s
        del x, p, s
    torch.cuda.synchronize()
    out["planes_on_card_s"] = time.perf_counter() - t
    rng = np.random.default_rng(seed + 41)
    view = cap.CapacitySearcher.from_device_planes(
        bf16, packed, scales, np.ones(N, bool), N)
    dead = rng.choice(N, N // 100, replace=False)
    t = time.perf_counter()
    view.set_rows_invalid(dead)
    out["delete_1pct_ms"] = (time.perf_counter() - t) * 1e3
    keep = rng.random(N) < 0.75  # the filter: 3 rows in 4
    flt = torch.from_numpy(keep).cuda()
    live = view._host_mask[:N] & keep
    picks = rng.choice(np.flatnonzero(live), Q, replace=False)
    q = (bf16[torch.from_numpy(picks).cuda()].float()
         + 0.02 * torch.randn((Q, D), generator=g, device="cuda"))
    q_host = q.cpu().numpy()
    before = S4.KERNEL.launches
    t = time.perf_counter()
    scores, idx = view.search(q_host, k=k, extra_mask=flt)
    out["first_search_ms_host_clock"] = (time.perf_counter() - t) * 1e3
    out["b3_launches_per_search"] = S4.KERNEL.launches - before
    out["search_ms_host_clock"] = host_ms(
        lambda: view.search(q_host, k=k, extra_mask=flt))
    if not live[idx].all():
        raise AssertionError("a deleted or filtered-out row came back")
    if list(idx[:, 0]) != list(picks):
        raise AssertionError("a query's own row is not its top hit")
    # The yardstick: the same bf16 rows' exact cosine, chunk by chunk.
    qn = q / q.norm(dim=1, keepdim=True)
    qb = qn.to(torch.bfloat16).float()
    live_dev = torch.from_numpy(live).cuda()
    best_s = torch.full((Q, k), -2.0, device="cuda")
    best_i = torch.zeros((Q, k), dtype=torch.int64, device="cuda")
    for lo in range(0, N, chunk):
        s = qb @ bf16[lo: lo + chunk].float().T
        s = torch.where(live_dev[lo: lo + chunk][None], s, -2.0)
        cs, ci = torch.topk(torch.cat([best_s, s], 1), k, dim=1)
        cat_i = torch.cat([best_i, torch.arange(
            lo, lo + chunk, device="cuda").expand(Q, -1)], 1)
        best_s, best_i = cs, torch.gather(cat_i, 1, ci)
    want_i = best_i.cpu().numpy()
    want = {(qi, int(r)): float(s) for qi, (rs, ss) in enumerate(zip(
        want_i, best_s.cpu().numpy())) for r, s in zip(rs, ss)}
    got = {(qi, int(r)): float(s) for qi, (rs, ss) in enumerate(zip(
        idx, scores)) for r, s in zip(rs, ss)}
    common = set(got) & set(want)
    err = max(abs(got[key] - want[key]) for key in common)
    if err > 1e-5:
        raise AssertionError(f"capacity hit scores off the bf16 cosine by "
                             f"{err}")
    out.update(
        rows=N, dim=D, queries=Q, k=k, deleted=len(dead),
        filter_keeps=float(keep.mean()),
        top10_overlap_with_exact=len(common) / (Q * k),
        hit_score_max_abs_err=err,
        residency_gb=(bf16.numel() * 2 + packed.numel() + scales.numel() * 4
                      + view.dev_mask.numel()) / 1e9,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if out["top10_overlap_with_exact"] < 0.9:
        raise AssertionError(f"capacity top-10 overlap {out}")
    log("capacity_search", **out)
    return out, view, q


def capacity_kernel_timing(torch, S4, search, view, q) -> dict:
    """B3 alone at the capacity view's N (device time, CUDA events) beside
    its byte bound and a bf16 matmul over the same rows, and its scores held
    bit for bit against the plain version on 65,536-row slices: at the
    start, across the first row past 2^31 packed bytes, and at the end. The
    plain version of the whole would need 43 GB of float64, so it is timed
    on one slice only (`plain_ms_65536_rows`)."""
    Q, D = q.shape
    N = view.n_rows
    qn = search.l2_normalize(q)
    q_i8 = search.quantize_rows_int8(qn)
    pen = torch.where(view.dev_mask, 0.0, search.NEG_INF).to(torch.float32)
    packed, scales = view.dev_packed, view.dev_scales
    got = S4.int4_scan_scores(q_i8, packed, scales, pen)
    torch.cuda.synchronize()
    line = (1 << 31) // (D // 2)  # the first row past 2^31 packed bytes
    if packed.shape[0] <= line:
        raise AssertionError(f"{packed.shape[0]} packed rows do not cross "
                             "2^31 bytes")
    n_rows, span, err = packed.shape[0], 65_536, 0.0
    for lo in (0, line - span // 2, n_rows - span):
        sl = slice(lo, lo + span)
        want = S4.int4_scan_scores_plain(q_i8, packed[sl], scales[sl],
                                         pen[sl])
        err = max(err, float((got[:, sl] - want).abs().max()))
    del got
    if err != 0.0:
        raise AssertionError(f"B3 at {n_rows} rows is off its plain version "
                             f"by {err} (bit-exact expected)")
    n_bytes = Q * D + N * D // 2 + 8 * N + 4 * Q * N
    b_ms, b_by = bound_ms(n_bytes, 2 * Q * N * D, "int8")
    qb = qn.to(torch.bfloat16)
    sl = slice(0, span)
    out = {"shape": [Q, N, D], "packed_bytes": N * D // 2,
           "max_abs_err": err, "checked_rows": [0, line - span // 2,
                                                 n_rows - span],
           "ms": cuda_ms(torch, lambda: S4.int4_scan_scores(
               q_i8, packed, scales, pen), reps=10),
           "bound_ms": b_ms, "bound_by": b_by,
           "bf16_matmul_ms": cuda_ms(torch, lambda: qb @ view.dev_bf16.T,
                                     reps=10),
           "plain_ms": None,
           "plain_ms_65536_rows": cuda_ms(
               torch, lambda: S4.int4_scan_scores_plain(
                   q_i8, packed[sl], scales[sl], pen[sl]), reps=3)}
    log("capacity_b3", **out)
    return out


def serve_in_thread(server) -> str:
    """Run an HTTP server on a daemon thread; its base URL."""
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def stop_servers(*servers) -> None:
    for s in servers:
        s.shutdown()
        s.server_close()


def http_json(method: str, url: str, body=None):
    """One raw JSON request, as the reference's qdrant-client sends it; the
    parsed reply."""
    req = urllib.request.Request(
        url, method=method, headers={"Content-Type": "application/json"},
        data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def assert_same_hits(tag: str, got, want, tol: float = 1e-6) -> None:
    """Equal top-k per query: the same ids, each score within ``tol`` (ids
    compared as sets: neither side promises an order among tied scores)."""
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} result lists, not "
                             f"{len(want)}")
    for qi, (g, w) in enumerate(zip(got, want)):
        gs, ws = {h.id: h.score for h in g}, {h.id: h.score for h in w}
        if len(g) != len(w) or gs.keys() != ws.keys() or any(
                abs(gs[i] - ws[i]) > tol for i in gs):
            raise AssertionError(f"{tag}: query {qi} hits differ: "
                                 f"{sorted(gs.items())} vs "
                                 f"{sorted(ws.items())}")


def overlap(a, b, k: int) -> float:
    """Mean top-k overlap of two lists of id sets."""
    return sum(len(x & y) for x, y in zip(a, b)) / (k * len(a))


def orthogonal_rows(np, rng, n: int, queries):
    """``n`` random rows orthogonal to every query: their cosine with each
    query is 0, so no top-k of these queries can take one in."""
    basis, _ = np.linalg.qr(queries.T.astype(np.float64))
    w = rng.standard_normal((n, queries.shape[1]))
    return (w - (w @ basis) @ basis.T).astype(np.float32)


SERVICE_TIERS = {"exact": {"exact": True}, "int8": {"exact": False},
                 "int4": {"method": "int4"}}


def service_path(torch, np, port, gallery, queries, root, seed: int):
    """The gallery as a service over the compacted 1M-row gallery: a
    ``.rbod`` root served with ``serve(warm=True)`` and a copy behind the
    Qdrant façade; ``GalleryClient`` searches per tier against the
    in-process search; binary upsert, deletes, retrieve / by-path / scroll /
    count; 8 reader threads and a writer against the serial oracle;
    ``/snapshot`` and a reload; the façade's raw REST calls and
    ``migrate.import_qdrant``; two shard servers behind ``serve_router``.
    Returns its numbers and the reloaded server's int8-tier hits."""
    import shutil

    server_lib, client_lib = port["server"], port["client"]
    router_lib, migrate = port["router"], port["migrate"]
    persist, store, schema = port["persist"], port["store"], port["schema"]
    S, S4 = port["int8_scan"], port["int4_scan"]
    Filter, Payload = schema.Filter, schema.Payload
    name, D, k = gallery.name, gallery.dim, 10
    rng = np.random.default_rng(seed + 50)
    out = {"rows": len(gallery), "queries": len(queries), "k": k}

    def launches():
        return S.KERNEL.launches, S4.KERNEL.launches

    def search_all(client):
        return {t: client.search(queries, k=k, **kw)
                for t, kw in SERVICE_TIERS.items()}

    # A snapshot root served warm, and a copy behind the Qdrant façade.
    t = time.perf_counter()
    local = store.VectorStore(device="cuda")
    local._collections[name] = gallery
    persist.save_store(local, root / "native")
    out["save_store_s"] = time.perf_counter() - t
    shutil.copytree(root / "native", root / "facade")
    b2 = S.KERNEL.launches
    t = time.perf_counter()
    srv = server_lib.serve(root / "native", host="127.0.0.1", port=0,
                           warm=True, device="cuda")
    url = serve_in_thread(srv)
    qsrv = server_lib.serve(root / "facade", host="127.0.0.1", port=0,
                            api="qdrant", device="cuda")
    qurl = serve_in_thread(qsrv)
    while http_json("GET", f"{url}/healthz")["warming"]:
        if time.perf_counter() - t > 600:
            raise AssertionError("the warm did not end in 600 s")
        time.sleep(0.05)
    out["load_and_warm_s"] = time.perf_counter() - t
    served = srv.service.store.get(name)
    # warm_async logs and skips a collection whose warm fails: check that
    # this one's serving tier exists and that its search launched B2.
    if served._dev_int8 is None or served._dev_f32 is None or \
            S.KERNEL.launches == b2:
        raise AssertionError("the warm built no int8 tier or launched no B2")
    out["warm_b2_launches"] = S.KERNEL.launches - b2

    # Each tier over REST equals the in-process search of the same tier.
    client = client_lib.GalleryClient(url, name)
    rest, out["rest_launches"] = {}, {}
    for tier, kw in SERVICE_TIERS.items():
        before = launches()
        rest[tier] = client.search(queries, k=k, **kw)
        out["rest_launches"][tier] = [a - b for a, b in
                                      zip(launches(), before)]
        assert_same_hits(f"REST {tier}", rest[tier],
                         gallery.search(queries, k=k, **kw))
    if out["rest_launches"] != {"exact": [0, 0], "int8": [1, 0],
                                "int4": [0, 1]}:
        raise AssertionError(f"REST launches {out['rest_launches']}")
    out["rest_ms_client_clock"] = {t: host_ms(lambda kw=kw: client.search(
        queries, k=k, **kw), 10) for t, kw in SERVICE_TIERS.items()}
    out["in_process_ms_host_clock"] = {t: host_ms(lambda kw=kw: served.search(
        queries, k=k, **kw), 10) for t, kw in SERVICE_TIERS.items()}
    flt = Filter(must={"class_name": "c3"})
    filtered = client.search(queries, k=k, flt=flt, exact=False)
    assert_same_hits("REST filtered", filtered,
                     gallery.search(queries, k=k, flt=flt, exact=False))
    if any(h.payload.class_name != "c3" for r in filtered for h in r):
        raise AssertionError("a filtered hit outside c3")
    log("service_tiers", **out)

    # Writes: 1,000 rows by the binary frame, 1,000 deleted by id (each
    # query's top hit among them).
    w = {}
    new_ids = [f"svc-{i}" for i in range(1000)]
    new_vecs = rng.standard_normal((1000, D), dtype=np.float32)
    new_pls = [Payload(data_type="original_images", class_name=f"c{i % 8}",
                       img_path=f"/svc/{i}.png") for i in range(1000)]
    t = time.perf_counter()
    if client.upsert(new_ids, new_vecs, new_pls) != 1000:
        raise AssertionError("the binary upsert did not take 1,000 rows")
    w["binary_upsert_1000_ms"] = (time.perf_counter() - t) * 1e3
    top1 = list(dict.fromkeys(r[0].id for r in rest["exact"]))
    others = [served._id_at(int(r)) for r in rng.choice(
        gallery._nrows, 1200, replace=False)]
    victims = (top1 + [i for i in others if i not in top1])[:1000]
    t = time.perf_counter()
    if client.delete(ids=victims) != 1000:
        raise AssertionError("the delete did not take 1,000 ids")
    w["delete_1000_ms"] = (time.perf_counter() - t) * 1e3
    after = search_all(client)
    want = live_exact_topk(torch, np, served, queries, k)
    if any(set(victims) & ids for r in after.values() for ids in ids_of(r)):
        raise AssertionError("a deleted id came back over REST")
    for tier in ("exact", "int8"):
        if ids_of(after[tier]) != want:
            raise AssertionError(f"REST {tier} after the writes differs from "
                                 "the exact search over the live rows")
    w["int4_top10_overlap_with_live_exact"] = overlap(
        ids_of(after["int4"]), want, k)
    if w["int4_top10_overlap_with_live_exact"] < 0.9:
        raise AssertionError(f"REST int4 overlap {w}")
    if [r[0].id for r in client.search(new_vecs[:16], k=1)] != new_ids[:16]:
        raise AssertionError("an upserted row is not its own top hit")

    # retrieve, by-path, scroll, count.
    got = client.retrieve(new_ids[:5], with_vectors=True)
    if [r.id for r in got] != new_ids[:5] or not all(
            np.array_equal(r.vector, v) for r, v in zip(got, new_vecs)):
        raise AssertionError("retrieve did not return the upserted rows")
    rec = client.get_by_path("/svc/7.png")
    if rec is None or rec.id != "svc-7":
        raise AssertionError(f"by-path returned {rec}")
    page, nxt = client.scroll(flt=flt, limit=50)
    if len(page) != 50 or nxt != 50 or any(r.payload.class_name != "c3"
                                           for r in page):
        raise AssertionError("a filtered scroll page is wrong")
    w["count"] = client.count()
    if w["count"] != len(served) or client.count(flt) != served.count(flt):
        raise AssertionError("count differs from the served gallery's")
    log("service_writes", **w)
    out.update(w)

    # The storm: 8 client threads x 16 searches while one writer upserts
    # and deletes rows orthogonal to every query, so each answer must
    # equal the serial oracle.
    oracle = client.search(queries, k=k, exact=False)
    stop, written, errors = threading.Event(), [0], []

    def writer():
        wc = client_lib.GalleryClient(url, name)
        prev = None
        try:
            while not stop.is_set():
                ids = [f"storm-{written[0]}-{i}" for i in range(64)]
                wc.upsert(ids, orthogonal_rows(np, rng, 64, queries),
                          [new_pls[0]] * 64)
                if prev is not None:
                    wc.delete(ids=prev)
                prev = ids
                written[0] += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def reader(i):
        rc = client_lib.GalleryClient(url, name)
        lat = []
        for _ in range(16):
            t0 = time.perf_counter()
            res = rc.search(queries, k=k, exact=False)
            lat.append((time.perf_counter() - t0) * 1e3)
            assert_same_hits(f"storm reader {i}", res, oracle)
        return lat

    wt = threading.Thread(target=writer)
    count0 = client.count()
    t = time.perf_counter()
    wt.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            lat = sorted(x for f in [ex.submit(reader, i) for i in range(8)]
                         for x in f.result())
    finally:
        stop.set()
        wt.join(timeout=120)
    if wt.is_alive() or errors or written[0] < 1:
        raise AssertionError(f"the writer: {errors or written[0]}")
    storm = {"seconds": time.perf_counter() - t, "searches": len(lat),
             "writer_batches": written[0],
             "p50_ms_client_clock": lat[len(lat) // 2],
             "p95_ms_client_clock": lat[int(len(lat) * 0.95)],
             "max_ms_client_clock": lat[-1]}
    if client.count() != count0 + 64:  # the writer's last batch stays
        raise AssertionError("the storm's end state is wrong")
    log("service_storm", **storm)
    out["storm"] = storm

    # /snapshot, a reload of the root, the same answers.
    before = search_all(client)
    t = time.perf_counter()
    saved = client_lib.RemoteVectorStore(url).snapshot()
    snap = {"snapshot_s": time.perf_counter() - t, "saved": saved}
    stop_servers(srv)
    del served, srv
    t = time.perf_counter()
    srv = server_lib.serve(root / "native", host="127.0.0.1", port=0,
                           device="cuda")
    url = serve_in_thread(srv)
    client = client_lib.GalleryClient(url, name)
    reloaded = search_all(client)
    snap["reload_and_first_searches_s"] = time.perf_counter() - t
    for tier in SERVICE_TIERS:
        assert_same_hits(f"reloaded {tier}", reloaded[tier], before[tier],
                         tol=0.0)
    log("service_snapshot", **snap)
    out["snapshot"] = snap

    # The Qdrant façade (its root is the copy from before the writes),
    # by the raw REST calls of the reference's qdrant-client.
    q_out = {}
    base = f"{qurl}/collections"
    must = {"must": [{"key": "class_name", "match": {"value": "c3"}}]}
    for tag, extra, want_hits in (
            ("approximate", {}, rest["int8"]),
            ("exact", {"params": {"exact": True}}, rest["exact"]),
            ("filtered", {"filter": must}, filtered)):
        hits = [http_json("POST", f"{base}/{name}/points/search", {
            "vector": q.tolist(), "limit": k, "with_payload": True,
            **extra})["result"] for q in queries]
        got = [[store.Record(id=str(h["id"]), payload=None, score=h["score"])
                for h in r] for r in hits]
        assert_same_hits(f"façade {tag}", got, want_hits)
    fv = rng.standard_normal((256, D), dtype=np.float32)
    fpl = [{"data_type": "original_images", "class_name": f"c{i % 8}",
            "img_path": f"/facade/{i}.png", "is_cropped": True,
            "is_segmented": False, "is_augmented": False,
            "is_delegate": False, "delegate_type": None} for i in range(256)]
    http_json("PUT", f"{base}/facade", {"vectors": {"size": D,
                                                    "distance": "Cosine"}})
    http_json("PUT", f"{base}/facade/points?wait=true", {"points": [
        {"id": i, "vector": fv[i].tolist(), "payload": fpl[i]}
        for i in range(256)]})
    native = client_lib.RemoteVectorStore(url).create_collection("facade",
                                                                 dim=D)
    native.upsert([str(i) for i in range(256)], fv, fpl)
    c1 = {"must": [{"key": "class_name", "match": {"value": "c1"}}]}
    hits = [http_json("POST", f"{base}/facade/points/search", {
        "vector": fv[i].tolist(), "limit": 5, "filter": c1,
        "with_payload": True})["result"] for i in range(0, 256, 37)]
    got = [[store.Record(id=str(h["id"]), payload=None, score=h["score"])
            for h in r] for r in hits]
    assert_same_hits("façade vs native", got, native.search(
        fv[0:256:37], k=5, flt=Filter(must={"class_name": "c1"}),
        exact=False))
    page = http_json("POST", f"{base}/facade/points/scroll", {
        "limit": 100, "with_payload": True, "with_vector": True,
        "filter": c1})["result"]["points"]
    if sorted(int(p["id"]) for p in page) != list(range(1, 256, 8)) or \
            not all(np.array_equal(np.asarray(p["vector"], np.float32),
                                   fv[int(p["id"])]) for p in page):
        raise AssertionError("the façade's filtered scroll is wrong")
    fresh = store.VectorStore(device="cuda")
    t = time.perf_counter()
    migrate.import_qdrant(fresh, qurl, collections=["facade"], quiet=True)
    q_out["import_256_s"] = time.perf_counter() - t
    imported = fresh.get("facade").retrieve([str(i) for i in range(256)],
                                            with_vectors=True)
    if len(imported) != 256 or not all(
            r.id == str(i) and np.array_equal(r.vector, fv[i])
            and r.payload.to_dict() == fpl[i]
            for i, r in enumerate(imported)):
        raise AssertionError("import_qdrant changed ids, vectors or payloads")
    stop_servers(qsrv)
    del qsrv, fresh, native
    log("service_qdrant", **q_out)

    # Two shard servers behind serve_router, each over the snapshot with
    # the other shard's ids (by shard_of) deleted: its exact top-10 is
    # the single server's.
    r_out = {}
    t = time.perf_counter()
    src = srv.service.store.get(name)
    all_ids = src._ids
    ids = [all_ids[r] for r in np.flatnonzero(src._mask_live(None))]
    which = [router_lib.shard_of(i, 2) for i in ids]
    shard_urls, shard_srvs = [], []
    for s in (0, 1):
        part = persist.load_store(root / "native", mmap_vectors=True,
                                  device="cuda")
        part.get(name).delete(ids=[i for i, w in zip(ids, which) if w != s])
        persist.save_store(part, root / f"shard{s}")
        del part
        shard_srvs.append(server_lib.serve(root / f"shard{s}",
                                           host="127.0.0.1", port=0,
                                           device="cuda"))
        shard_urls.append(serve_in_thread(shard_srvs[-1]))
    r_out["split_and_save_s"] = time.perf_counter() - t
    r_out["shard_rows"] = [which.count(s) for s in (0, 1)]
    rsrv = router_lib.serve_router(shard_urls, host="127.0.0.1", port=0)
    rurl = serve_in_thread(rsrv)
    rclient = client_lib.GalleryClient(rurl, name)
    t = time.perf_counter()
    assert_same_hits("router exact", rclient.search(queries, k=k),
                     reloaded["exact"])
    r_out["first_exact_search_s"] = time.perf_counter() - t
    if rclient.count() != client.count():
        raise AssertionError("the router's count differs")
    routed = [f"routed-{i}" for i in range(64)]
    rv = rng.standard_normal((64, D), dtype=np.float32)
    rclient.upsert(routed, rv, new_pls[:64])
    client.upsert(routed, rv, new_pls[:64])
    for s, u in enumerate(shard_urls):
        mine = [i for i in routed if router_lib.shard_of(i, 2) == s]
        got = client_lib.GalleryClient(u, name).retrieve(routed,
                                                         with_vectors=False)
        if sorted(r.id for r in got) != sorted(mine):
            raise AssertionError(f"shard {s} holds the wrong routed ids")
    probe = np.concatenate([queries, rv[:16]])
    assert_same_hits("router exact after a routed write",
                     rclient.search(probe, k=k), client.search(probe, k=k))
    r_out["search_ms_client_clock"] = host_ms(
        lambda: rclient.search(queries, k=k))
    stop_servers(rsrv, *shard_srvs, srv)
    rsrv.service._pool.shutdown()
    log("service_router", **r_out)
    out["router"] = r_out
    return out, reloaded["int8"]


def sharded_path(torch, np, port, gallery, queries, root, reloaded,
                 seed: int):
    """The sharded tier on one card: ``attach_mesh`` of a 4-shard mesh that
    lists cuda:0 four times, so B2 or B3 launches once per shard per
    search; each tier against the single-device one; 1,000 rows upserted
    and 1,000 deleted through the store API (the view patched, not
    rebuilt); then ``serve(mesh_devices=-1)`` (one shard on one card) and a
    REST search. Returns its numbers and the view, for the kernel checks
    after the path's counts are read."""
    mesh_lib, server_lib = port["mesh"], port["server"]
    client_lib, schema = port["client"], port["schema"]
    S, S4 = port["int8_scan"], port["int4_scan"]
    k, D = 10, gallery.dim
    rng = np.random.default_rng(seed + 60)
    out = {"rows": len(gallery), "queries": len(queries), "k": k}
    single = {t: gallery.search(queries, k=k, method=t)
              for t in ("exact", "int8")}
    mesh = mesh_lib.make_mesh({"gallery": 4}, ["cuda:0"] * 4)
    gallery.attach_mesh(mesh)
    t = time.perf_counter()
    auto = gallery.search(queries, k=k)  # method=None: the sharded tier
    out["view_build_and_first_search_s"] = time.perf_counter() - t
    view = gallery._shard_view
    if view is None:
        raise AssertionError("method=None did not route to the sharded tier")
    out["rows_per_shard"] = view.rows_per
    out["devices"] = [str(d) for d in view.devices]
    assert_same_hits("sharded auto", auto, single["exact"])
    res, out["launches_per_search"] = {}, {}
    for tier in ("sharded_exact", "sharded_int8", "sharded_int4"):
        gallery.search(queries, k=k, method=tier)  # builds its mirror
        b2, b3 = S.KERNEL.launches, S4.KERNEL.launches
        res[tier] = gallery.search(queries, k=k, method=tier)
        out["launches_per_search"][tier] = {
            "B2": S.KERNEL.launches - b2, "B3": S4.KERNEL.launches - b3}
    if out["launches_per_search"] != {
            "sharded_exact": {"B2": 0, "B3": 0},
            "sharded_int8": {"B2": 4, "B3": 0},
            "sharded_int4": {"B2": 0, "B3": 4}}:
        raise AssertionError(f"sharded launches {out['launches_per_search']}")
    assert_same_hits("sharded_exact", res["sharded_exact"], single["exact"])
    if ids_of(res["sharded_int8"]) != ids_of(single["int8"]):
        raise AssertionError("sharded_int8 ids differ from the int8 tier's")
    out["int4_top10_overlap_with_exact"] = overlap(
        ids_of(res["sharded_int4"]), ids_of(single["exact"]), k)
    if out["int4_top10_overlap_with_exact"] < 0.9:
        raise AssertionError(f"sharded int4 overlap {out}")
    out["search_ms_host_clock"] = {t: host_ms(
        lambda t=t: gallery.search(queries, k=k, method=t))
        for t in res}
    log("sharded_tiers", **out)

    # Writes through the store API patch the view in place.
    w = {}
    new_ids = [f"shard-new-{i}" for i in range(1000)]
    new_vecs = rng.standard_normal((1000, D), dtype=np.float32)
    t = time.perf_counter()
    gallery.upsert(new_ids, new_vecs, [schema.Payload(
        data_type="original_images", class_name=f"c{i % 8}", img_path="")
        for i in range(1000)])
    top1 = list(dict.fromkeys(r[0].id for r in res["sharded_exact"]))
    others = [gallery._id_at(int(r)) for r in rng.choice(
        len(gallery) - 1000, 1200, replace=False)]
    victims = (top1 + [i for i in others if i not in top1])[:1000]
    if gallery.delete(ids=victims) != 1000:
        raise AssertionError("the delete did not take 1,000 ids")
    w["upsert_and_delete_1000_s"] = time.perf_counter() - t
    if [r[0].id for r in gallery.search(new_vecs[:16], k=1)] != \
            new_ids[:16]:
        raise AssertionError("an upserted row is not its own sharded hit")
    want = live_exact_topk(torch, np, gallery, queries, k)
    after = {t: gallery.search(queries, k=k, method=t) for t in res}
    if gallery._shard_view is not view:
        raise AssertionError("a write rebuilt the sharded view")
    if any(set(victims) & ids for r in after.values() for ids in ids_of(r)):
        raise AssertionError("a deleted id came back from the sharded tier")
    for tier in ("sharded_exact", "sharded_int8"):
        if ids_of(after[tier]) != want:
            raise AssertionError(f"{tier} after the writes differs from the "
                                 "exact search over the live rows")
    w["int4_top10_overlap_with_live_exact"] = overlap(
        ids_of(after["sharded_int4"]), want, k)
    if w["int4_top10_overlap_with_live_exact"] < 0.9:
        raise AssertionError(f"sharded int4 overlap after writes {w}")
    gallery.detach_mesh()
    log("sharded_writes", **w)
    out.update(w)

    # mesh_devices=-1 clamps to the cards there are: one shard on cuda:0.
    t = time.perf_counter()
    srv = server_lib.serve(root / "native", host="127.0.0.1", port=0,
                           mesh_devices=-1, device="cuda")
    url = serve_in_thread(srv)
    if srv.service.store.get(gallery.name)._gallery_mesh.shape != {
            "gallery": torch.cuda.device_count()}:
        raise AssertionError("mesh_devices=-1 did not take every card")
    client = client_lib.GalleryClient(url, gallery.name)
    client.search(queries, k=k, exact=False)  # builds the view
    b2 = S.KERNEL.launches
    hits = client.search(queries, k=k, exact=False)
    out["mesh_server_b2_launches"] = S.KERNEL.launches - b2
    if out["mesh_server_b2_launches"] != torch.cuda.device_count():
        raise AssertionError(f"mesh server launches {out}")
    assert_same_hits("mesh server", hits, reloaded)
    out["mesh_server_s"] = time.perf_counter() - t
    stop_servers(srv)
    log("sharded_serve", mesh_server_s=out["mesh_server_s"],
        b2_launches=out["mesh_server_b2_launches"])
    return out, view


def shard_kernel_checks(torch, port, view, queries) -> dict:
    """B2 and B3 on each shard of the sharded view (its shape on the
    path) against their plain scans, bit for bit, and one shard's kernel
    time; after the path's counts are read."""
    search, S, S4 = port["search"], port["int8_scan"], port["int4_scan"]
    q = search.l2_normalize(torch.from_numpy(queries).cuda())
    q_i8 = search.quantize_rows_int8(q)
    err = {"B2": 0.0, "B3": 0.0}
    for s in range(len(view.devices)):
        pen = torch.where(view.dev_mask[s], 0.0, search.NEG_INF).to(
            torch.float32)
        packed, scales = view._dev_int4[s]
        for kid, got, want in (
                ("B2", S.int8_scan_scores(q_i8, view._dev_int8[s], pen),
                 S.int8_scan_scores_plain(q_i8, view._dev_int8[s], pen)),
                ("B3", S4.int4_scan_scores(q_i8, packed, scales, pen),
                 S4.int4_scan_scores_plain(q_i8, packed, scales, pen))):
            err[kid] = max(err[kid], float((got - want).abs().max()))
    if err != {"B2": 0.0, "B3": 0.0}:
        raise AssertionError(f"a shard's scan is off its plain version {err}")
    pen = torch.where(view.dev_mask[0], 0.0, search.NEG_INF).to(
        torch.float32)
    packed, scales = view._dev_int4[0]
    Q, N, D = len(queries), view.rows_per, view.dev_vectors[0].shape[1]
    # One shard's scan: the queries, the rows, the penalties (and B3's
    # scales) read once, the [Q, N] f32 scores written once.
    b2_bound, _ = bound_ms(Q * D + N * D + 4 * N + 4 * Q * N,
                           2 * Q * N * D, "int8")
    b3_bound, _ = bound_ms(Q * D + N * D // 2 + 8 * N + 4 * Q * N,
                           2 * Q * N * D, "int8")
    rows = view._dev_int8[0]
    int_mm = int_mm_yardstick(torch, q_i8, rows, pen,
                              S.int8_scan_scores_plain(q_i8, rows, pen),
                              reps=10)
    out = {"shape": [Q, N, D], "shards": len(view.devices),
           "max_abs_err": err, "b2_bound_ms_one_shard": b2_bound,
           "b3_bound_ms_one_shard": b3_bound,
           "b2_ms_one_shard": cuda_ms(torch, lambda: S.int8_scan_scores(
               q_i8, rows, pen), reps=10),
           "int_mm_ms_one_shard": int_mm["library_ms"],
           "int_mm_full_ms_one_shard": int_mm["library_full_ms"],
           "b3_ms_one_shard": cuda_ms(torch, lambda: S4.int4_scan_scores(
               q_i8, packed, scales, pen), reps=10)}
    log("sharded_kernels", **out)
    return out


def analysis_phase(port, csv_paths) -> dict:
    """analyze(make_plots=False) on the experiment path's result CSVs: the
    summary and the eight metric files with the reference's names."""
    out = {}
    for mode, path in csv_paths.items():
        t = time.perf_counter()
        res = port["analysis"].analyze(path, make_plots=False)
        names = sorted(p.name for p in (path.parent / "metrics").iterdir())
        if names != sorted(f"metrics_{c}_{d}.csv" for c in ("pre_a", "pre_b")
                           for d in ("average", "centroid", "medoid",
                                     "weighted")) \
                or not res["summary_path"].exists() \
                or len(res["summary"]["case"]) != 8:
            raise AssertionError(f"{mode}: analysis wrote {names}")
        if mode == "same_class" and any(
                m["precision"][m["label"].index("accuracy")] != 1.0
                for m in res["metrics"].values()):
            raise AssertionError("same_class accuracy is not 1")
        out[mode] = {"seconds": time.perf_counter() - t,
                     "metric_files": len(names)}
    log("analysis", **out)
    return out


def write_class_tree(np, root, seed: int, per_class: int, sizes=(224, 300),
                     classes: int = len(COLORS)) -> int:
    """``root/original_images/class<c>/img_<i>.png``: ``per_class`` colour
    scenes of each class, their sides drawn from ``sizes``. Encoded on 8
    threads."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    jobs = []
    for c in range(classes):
        d = root / "original_images" / f"class{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            h, w = rng.integers(*sizes, 2)
            jobs.append((scene(np, rng, COLORS[c], h, w), d / f"img_{i}.png"))
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda j: Image.fromarray(j[0]).save(
            j[1], compress_level=1), jobs))
    return len(jobs)


def training_path(torch, np, port, seed: int) -> dict:
    """CLIP fine-tuning at full ViT-B/32 width through ``fit``: bf16
    compute on f32 master weights, linear head, batch 64, 2 epochs of a
    384-image tree of 8 colour classes (12 steps) with a checkpoint every 5
    steps, then a resumed epoch (6 steps) with the cosine schedule. Every
    tower block runs B1 forward and B5 backward."""
    import tempfile
    from pathlib import Path

    clip_model, loop = port["clip_model"], port["train_loop"]
    cfg = clip_model.VIT_B_32
    params = clip_model.params_from_jax(clip_model.init_params(cfg, seed))
    out = {"batch": 64, "compute_dtype": "bfloat16", "head": "linear"}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        out["tree_images"] = write_class_tree(np, root / "tree", seed + 10,
                                              per_class=48)
        out["tree_write_s"] = time.perf_counter() - t
        log_file = root / "train.jsonl"
        fits = []
        for epochs, schedule in ((2, "constant"), (1, "cosine")):
            fit_cfg = loop.FitConfig(
                root_dir=str(root / "tree"), epochs=epochs, batch_size=64,
                checkpoint_dir=str(root / "ckpt"), checkpoint_every=5,
                seed=seed, lr_schedule=schedule, log_file=str(log_file))
            t = time.perf_counter()
            _, metrics = loop.fit(cfg, fit_cfg, params=params, device="cuda")
            torch.cuda.synchronize()
            fits.append((time.perf_counter() - t, metrics))
        events = [json.loads(line)
                  for line in log_file.read_text().splitlines()]
        ckpt = port["checkpoint"].TrainCheckpointer(root / "ckpt")
        kept = ckpt.all_steps()
        # Where fit's time goes, on the host clock: one batch of 64
        # decoded and preprocessed as fit's loader does (one thread), and
        # one checkpoint (tower, head, both AdamW moments) written again.
        entries = port["tree"].walk(root / "tree", "original")[:64]
        t = time.perf_counter()
        for e in entries:
            port["preprocess"].load_and_preprocess(e.path)
        out["decode_64_s"] = time.perf_counter() - t
        state = ckpt.restore(map_location="cuda")
        t = time.perf_counter()
        port["checkpoint"].TrainCheckpointer(root / "timing").save(1, state)
        out["checkpoint_save_s"] = time.perf_counter() - t
        out["checkpoint_bytes"] = (root / "timing" / "1" / "state.pt"
                                   ).stat().st_size
    epochs = [e for e in events if e["event"] == "epoch"]
    resume = [e for e in events if e["event"] == "resume"]
    saves = [e["step"] for e in events if e["event"] == "checkpoint"]
    steps = sum(e["steps"] for e in epochs)
    losses = [e["mean_loss"] for e in epochs]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"epoch mean losses {losses}")
    if len(resume) != 1 or resume[0]["step"] != 12 or \
            resume[0]["total_steps"] != 18:
        raise AssertionError(f"resume {resume}: expected step 12 of 18")
    if saves != [5, 10, 12, 15, 18] or kept != [12, 15, 18]:
        raise AssertionError(f"checkpoints saved {saves}, kept {kept}")
    out.update(
        steps=steps, epoch_mean_loss=losses,
        last_metrics=[m for _, m in fits], resume=resume[0],
        checkpoints_saved=saves, checkpoints_kept=kept,
        fit_s_host_clock=[f for f, _ in fits],
        epoch_images_per_s=[e["throughput"] for e in epochs],
        steps_per_s=steps / sum(f for f, _ in fits),
        images_per_s=64 * steps / sum(f for f, _ in fits))
    log("training_path", **out)
    return out


def training_checks(torch, np, port, seed: int) -> dict:
    """One training step's gradients at full ViT-B/32 width in f32, with
    B1/B5 against the same step with the plain attention core, both on the
    card. Tolerance per parameter tensor: max |difference| within 1e-3 of
    its largest plain gradient (f32 sums in another order, carried back
    through 12 blocks). Then the device time of one bf16 train step of 64
    crops alone (CUDA events)."""
    clip_model, T = port["clip_model"], port["train"]
    cfg = clip_model.VIT_B_32
    tcfg = T.TrainConfig(num_classes=8, compute_dtype="float32")
    model, _ = T.init_state(cfg, tcfg, seed=seed, device="cuda")
    rng = np.random.default_rng(seed + 11)
    x = torch.from_numpy(rng.normal(size=(64, 224, 224, 3)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 8, 64)).cuda()

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = T.loss_fn(model, x, y, tcfg)
        loss.backward()
        return float(loss.detach()), {k: p.grad.clone()
                             for k, p in model.named_parameters()}

    loss_k, g_kernel = grads()
    original = clip_model.clip_attention_core
    clip_model.clip_attention_core = \
        port["clip_attention"].clip_attention_core_plain
    try:
        loss_p, g_plain = grads()
    finally:
        clip_model.clip_attention_core = original
    worst = max((g_kernel[k] - g_plain[k]).abs().max().item()
                / max(g_plain[k].abs().max().item(), 1e-30) for k in g_plain)
    if worst > 1e-3 or abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        raise AssertionError(f"gradients differ: worst relative {worst}, "
                             f"loss {loss_k} vs {loss_p}")
    out = {"loss_kernel": loss_k, "loss_plain": loss_p,
           "worst_max_abs_diff_over_max_abs_grad": worst, "tolerance": 1e-3,
           "tensors": len(g_plain)}
    del model, g_kernel, g_plain
    bcfg = T.TrainConfig(num_classes=8)  # bf16 compute, as fit's default
    model, opt = T.init_state(cfg, bcfg, seed=seed, device="cuda")
    step = T.make_train_step(bcfg)
    out["step_bf16_64_ms"] = cuda_ms(torch, lambda: step(model, opt, x, y),
                                     reps=5, warmup=2)
    log("training_checks", **out)
    return out


MESH_SIZES = {"dp": 2, "tp": 2}  # on cuda:0 listed four times
MESH_ENCODER_CALLS = 4  # make_sharded_encoder calls of 64 crops


def mesh_training_path(torch, np, port, seed: int) -> dict:
    """CLIP fine-tuning on a dp × tp mesh: ``fit`` with ``mesh=`` a 2 × 2
    mesh listing cuda:0 four times (one controller's loop on one card, not
    a collective), ViT-B/32 at full width, bf16 on f32 master weights,
    linear head, global batch 64 (32 a dp shard), one epoch of the 384-image
    tree of ``training_path`` (6 steps) with its checkpoint; then one epoch
    resumed from that checkpoint on one device (no mesh, 6 steps). Then
    ``make_sharded_encoder`` on dp = 2 (cuda:0 twice) encodes 64 crops
    ``MESH_ENCODER_CALLS`` times. B1 and B5 launch once per dp shard and
    block on the mesh (2 × 12 a step), 12 a step on one device, and B1
    2 × 12 an encoder call: the counts the path must read."""
    import tempfile
    from pathlib import Path

    clip_model, loop = port["clip_model"], port["train_loop"]
    cfg = clip_model.VIT_B_32
    params = clip_model.params_from_jax(clip_model.init_params(cfg, seed))
    t_path = time.perf_counter()
    mesh = port["mesh"].make_mesh(MESH_SIZES, ["cuda:0"] * 4)
    out = {"mesh": MESH_SIZES, "devices": [str(d) for d in
                                           mesh.devices.flat],
           "batch": 64, "compute_dtype": "bfloat16", "head": "linear"}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        root = Path(tmp)
        out["tree_images"] = write_class_tree(np, root / "tree", seed + 10,
                                              per_class=48)
        log_file = root / "train.jsonl"
        fits = []
        for where in (mesh, None):
            fit_cfg = loop.FitConfig(
                root_dir=str(root / "tree"), epochs=1, batch_size=64,
                checkpoint_dir=str(root / "ckpt"), checkpoint_every=100,
                seed=seed, log_file=str(log_file))
            t = time.perf_counter()
            _, metrics = loop.fit(cfg, fit_cfg, params=params,
                                  device="cuda", mesh=where)
            torch.cuda.synchronize()
            fits.append((time.perf_counter() - t, metrics))
        events = [json.loads(line)
                  for line in log_file.read_text().splitlines()]
        kept = port["checkpoint"].TrainCheckpointer(root / "ckpt").all_steps()
    epochs = [e for e in events if e["event"] == "epoch"]
    resume = [e for e in events if e["event"] == "resume"]
    losses = [e["mean_loss"] for e in epochs]
    mesh_steps, one_steps = (e["steps"] for e in epochs)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"mesh epoch mean losses {losses}")
    if len(resume) != 1 or resume[0]["step"] != mesh_steps or \
            kept != [mesh_steps, mesh_steps + one_steps]:
        raise AssertionError(f"resume {resume}, checkpoints {kept}: "
                             f"expected a resume at step {mesh_steps}")

    x = np.random.default_rng(seed + 12).normal(
        size=(64, 224, 224, 3)).astype(np.float32)
    encode = port["embed"].make_sharded_encoder(
        params, port["mesh"].make_mesh({"dp": 2}, ["cuda:0"] * 2), cfg,
        compute_dtype="float32")
    encode(x)  # first call
    t = time.perf_counter()
    for _ in range(MESH_ENCODER_CALLS - 1):
        emb = encode(x)
    encode_s = (time.perf_counter() - t) / (MESH_ENCODER_CALLS - 1)
    if emb.shape != (64, cfg.embed_dim) or not np.isfinite(emb).all():
        raise AssertionError(f"sharded encoder: {emb.shape}")
    layers, dp = cfg.layers, MESH_SIZES["dp"]
    out.update(
        steps={"mesh": mesh_steps, "one_device_resumed": one_steps},
        epoch_mean_loss=losses, resume=resume[0], checkpoints_kept=kept,
        last_metrics=[m for _, m in fits],
        fit_s_host_clock=[f for f, _ in fits],
        epoch_images_per_s=[e["throughput"] for e in epochs],
        sharded_encoder={"dp": 2, "crops": 64,
                         "crops_per_s_host_clock": 64 / encode_s},
        expected_launches={
            "B1": dp * layers * mesh_steps + layers * one_steps
            + dp * layers * MESH_ENCODER_CALLS,
            "B5": dp * layers * mesh_steps + layers * one_steps},
        seconds=time.perf_counter() - t_path)
    log("mesh_training_path", **out)
    return out


def mesh_training_checks(torch, np, port, seed: int) -> dict:
    """One f32 step's gradients at full ViT-B/32 width on the 2 × 2 mesh of
    cuda:0 against the one-device step on the card, batch 64: the loss to
    1e-5 relative, each parameter tensor (its pieces joined) within 1e-3 of
    its largest one-device gradient (the row-parallel partial products are
    added in another order, carried back through 12 blocks). Then the
    device time of one bf16 step of 64 on the mesh beside the one-device
    step (CUDA events; the device-busy time and operations by the
    profiler), and ``make_sharded_encoder`` (dp = 2) against
    ``make_encoder`` on 64 crops in f32: within 1e-4 of the largest
    embedding entry (the same tower at another batch size may take other
    matmul tilings), with both encoders' crops/s."""
    clip_model, T = port["clip_model"], port["train"]
    cfg = clip_model.VIT_B_32
    mesh = port["mesh"].make_mesh(MESH_SIZES, ["cuda:0"] * 4)
    rng = np.random.default_rng(seed + 11)
    x = torch.from_numpy(rng.normal(size=(64, 224, 224, 3)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 8, 64)).cuda()
    tcfg = T.TrainConfig(num_classes=8, compute_dtype="float32")
    one, opt = T.init_state(cfg, tcfg, seed=seed, device="cuda")
    placed, _ = T.place(one, opt, mesh)
    losses = []
    for model in (one, placed):
        loss, _ = T.loss_fn(model, x, y, tcfg)
        loss.backward()
        losses.append(float(loss.detach()))
    worst = 0.0
    for p, (pieces, sh) in zip(one.parameters(), T.pieces(placed)):
        g = sh.join([q.grad for q in pieces])
        worst = max(worst, (g - p.grad).abs().max().item()
                    / max(p.grad.abs().max().item(), 1e-30))
    if worst > 1e-3 or abs(losses[1] - losses[0]) > 1e-5 * abs(losses[0]):
        raise AssertionError(f"mesh gradients differ: worst relative "
                             f"{worst}, loss {losses[1]} vs {losses[0]}")
    out = {"loss_one_device": losses[0], "loss_mesh": losses[1],
           "worst_max_abs_diff_over_max_abs_grad": worst, "tolerance": 1e-3,
           "tensors": len(list(one.parameters()))}
    del one, placed, opt
    bcfg = T.TrainConfig(num_classes=8)  # bf16 compute, as fit's default
    step = T.make_train_step(bcfg)
    for name, where in (("one_device", None), ("mesh", mesh)):
        model, opt = T.init_state(cfg, bcfg, seed=seed, device="cuda")
        if where is not None:
            model, opt = T.place(model, opt, where)
        out[f"step_bf16_64_ms_{name}"] = ms = cuda_ms(
            torch, lambda: step(model, opt, x, y), reps=5, warmup=2)
        busy, ops = device_profile(torch, lambda: step(model, opt, x, y),
                                   reps=3)
        out[f"step_bf16_64_device_busy_ms_{name}"] = busy
        out[f"step_bf16_64_device_ops_{name}"] = ops
        out[f"step_bf16_64_idle_share_{name}"] = max(0.0, 1 - busy / ms)
        del model, opt
    torch.cuda.empty_cache()

    params = clip_model.params_from_jax(clip_model.init_params(cfg, seed))
    crops = x.cpu().numpy()
    encoders = {
        "sharded_dp2": port["embed"].make_sharded_encoder(
            params, port["mesh"].make_mesh({"dp": 2}, ["cuda:0"] * 2), cfg,
            compute_dtype="float32"),
        "single": port["embed"].make_encoder(params, cfg, device="cuda")}
    embs = {}
    for name, encode in encoders.items():
        embs[name] = encode(crops)
        t = time.perf_counter()
        for _ in range(3):
            encode(crops)
        out[f"encoder_{name}_crops_per_s_host_clock"] = \
            3 * 64 / (time.perf_counter() - t)
    diff = float(np.abs(embs["sharded_dp2"] - embs["single"]).max())
    scale = float(np.abs(embs["single"]).max())
    if not diff <= 1e-4 * scale:
        raise AssertionError(f"sharded encoder: {diff} from make_encoder "
                             f"(largest entry {scale})")
    out.update(encoder_max_abs_diff=diff, encoder_max_abs=scale,
               encoder_tolerance="1e-4 of the largest entry")
    log("mesh_training_checks", **out)
    return out


def segment_path(torch, np, port, seed: int):
    """The segment stage at full SAM-B width (1024 px, embed 768, 12
    blocks, global blocks 2/5/8/11, decoder 256), f32, from seeded weights:
    ``run_auto_segment`` over 2 classes x 8 images of 300-500 px and one
    file that does not decode, 4 images per encoder call, then
    ``set_image`` and 3 ``predict`` calls on one image. Returns its numbers
    (the encoder forwards it ran among them), the predictor and the image
    it predicted on."""
    import tempfile
    from pathlib import Path

    from PIL import Image

    M, seg = port["sam"], port["segment"]
    t0 = time.perf_counter()
    predictor = M.SamPredictor(M.params_from_jax(M.init_params(
        M.SAM_VIT_B, seed)), M.SAM_VIT_B, device="cuda")
    out = {"init_s": time.perf_counter() - t0, "batch_size": 4}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sam_") as tmp:
        root = Path(tmp)
        src = root / "dataset_cropped"
        n = write_class_tree(np, src, seed + 12, per_class=8,
                             sizes=(300, 500), classes=2)
        (src / "original_images" / "class0" / "broken.png").write_bytes(
            b"not an image")
        files = n + 1
        t = time.perf_counter()
        res = seg.run_auto_segment(seg.SegmentConfig(
            src_root=str(src), dst_root=str(root / "dataset_segmented")),
            predictor, batch_size=4)
        torch.cuda.synchronize()
        out["auto_segment_s"] = time.perf_counter() - t
        if (res.n_segmented, res.n_failed) != (n, 1):
            raise AssertionError(f"run_auto_segment: {res}")
        written = sorted((root / "dataset_segmented").rglob("*.png"))
        sources = sorted(p for p in src.rglob("img_*.png"))
        if [p.name for p in written] != [p.name for p in sources]:
            raise AssertionError("segmented file names differ from sources")
        for dst, srcp in zip(written, sources):
            rgba = np.asarray(Image.open(dst))
            rgb = np.asarray(Image.open(srcp).convert("RGB"))
            if rgba.shape != rgb.shape[:2] + (4,) or \
                    not np.array_equal(rgba[..., :3], rgb) or \
                    not set(np.unique(rgba[..., 3])) <= {0, 255}:
                raise AssertionError(f"bad RGBA output {dst.name}")
        img = np.asarray(Image.open(sources[0]).convert("RGB"))
    h, w = img.shape[:2]
    t = time.perf_counter()
    predictor.set_image(img)
    torch.cuda.synchronize()
    out["set_image_ms"] = (time.perf_counter() - t) * 1e3
    predict_ms = []
    for pts, lbl in (([[w / 2, h / 2]], [1]),
                     ([[w / 4, h / 4], [w / 2, h / 2]], [0, 1]),
                     ([[3 * w / 4, h / 3]], [1])):
        t = time.perf_counter()
        masks, scores = predictor.predict(np.array(pts), np.array(lbl))
        predict_ms.append((time.perf_counter() - t) * 1e3)
        if masks.shape != (3, h, w) or not np.isfinite(scores).all():
            raise AssertionError(f"predict {masks.shape} {scores}")
    out["predict_ms"] = predict_ms
    chunks = -(-files // 4)  # every chunk holds a decodable image
    out.update(files=files, n_segmented=res.n_segmented,
               n_failed=res.n_failed, encoder_forwards=chunks + 1,
               images_per_s=res.n_segmented / out["auto_segment_s"],
               seconds=time.perf_counter() - t0)
    log("segment_path", **out)
    return out, predictor, img


def segment_checks(torch, np, port, predictor, img, seed: int) -> dict:
    """On the card: the encoder with B6 against the same forward with the
    einsum attention, in f32 and in bf16, and ``segment_batch`` against
    per-image ``predict`` (iou atol 1e-5, masks agree above 0.999, as
    tests/test_sam.py); then the encoder alone at batch 1 and 4 in both
    dtypes."""
    M, E = port["sam"], port["sam_encoder"]
    cfg = M.SAM_VIT_B.encoder
    padded, _ = M.preprocess_image(img, cfg.img_size)
    x = torch.from_numpy(padded[None]).cuda()
    with torch.inference_mode():
        flash = E.forward(predictor.params["encoder"], x, cfg)
        einsum = E.forward(predictor.params["encoder"], x, cfg,
                           use_flash=False)
    enc_err = float((flash - einsum).abs().max())
    # 1e-3: f32 sums in another order in every attention layer, carried
    # through 12 blocks and the neck (the JAX package holds its 2-block
    # grid-16 encoder to 1e-4, tests/test_flash_2d_bias.py).
    if enc_err > 1e-3:
        raise AssertionError(f"encoder B6 vs einsum: max abs err {enc_err}")
    # bf16 (compute_dtype=torch.bfloat16): B6 against the einsum path. Both
    # round at every layer (the kernel its unnormalised p, the einsum path
    # the normalised one), so they differ by bf16 noise, not by an error
    # bound. Tolerance, relative L2 over the whole output: B6's bf16 encoder
    # within 3e-2 of the einsum bf16 encoder, and no further from the f32
    # einsum encoder than 1.5x the einsum bf16 encoder's own distance to it.
    with torch.inference_mode():
        flash16 = E.forward(predictor.params["encoder"], x, cfg,
                            torch.bfloat16).float()
        einsum16 = E.forward(predictor.params["encoder"], x, cfg,
                             torch.bfloat16, use_flash=False).float()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    bf16_out = {"encoder_bf16_rel_l2_b6_vs_einsum": rel(flash16, einsum16),
                "encoder_bf16_rel_l2_b6_vs_f32": rel(flash16, einsum),
                "encoder_bf16_rel_l2_einsum_vs_f32": rel(einsum16, einsum),
                "encoder_bf16_max_abs_err_b6_vs_einsum": float(
                    (flash16 - einsum16).abs().max()),
                "encoder_bf16_tolerance": {"rel_l2_vs_einsum": 3e-2,
                                           "vs_f32_factor": 1.5}}
    if not bool(torch.isfinite(flash16).all()) or \
            bf16_out["encoder_bf16_rel_l2_b6_vs_einsum"] > 3e-2 or \
            bf16_out["encoder_bf16_rel_l2_b6_vs_f32"] > \
            1.5 * bf16_out["encoder_bf16_rel_l2_einsum_vs_f32"]:
        raise AssertionError(f"bf16 encoder B6 vs einsum: {bf16_out}")
    del flash16, einsum16
    rng = np.random.default_rng(seed + 13)
    imgs = [img, scene(np, rng, COLORS[3], 420, 360)]
    t = time.perf_counter()
    batched = predictor.segment_batch(imgs)
    batch_ms = (time.perf_counter() - t) * 1e3
    agree, iou_err = [], 0.0
    for im, (mb, ib) in zip(imgs, batched):
        h, w = im.shape[:2]
        predictor.set_image(im)
        ms, is_ = predictor.predict(np.array([[w / 2, h / 2]]),
                                    np.array([1]))
        iou_err = max(iou_err, float(np.abs(ib - is_).max()))
        agree.append(float((mb == ms).mean()))
    if iou_err > 1e-5 or min(agree) <= 0.999:
        raise AssertionError(f"segment_batch vs predict: iou err {iou_err}, "
                             f"mask agreement {agree}")
    # Where a segment call's time goes: the encoder alone at batch 1 and 4
    # and the decoder alone (CUDA events), and the host's resize of one
    # image's 3 mask logits to its original size.
    D = port["sam_decoder"]
    with torch.inference_mode():
        x4 = x.expand(4, -1, -1, -1).contiguous()
        enc_ms = {f"encoder_batch{len(b)}_ms": cuda_ms(
            torch, lambda b=b: E.forward(predictor.params["encoder"], b, cfg),
            reps=3, warmup=1) for b in (x, x4)}
        enc_ms.update({f"encoder_bf16_batch{len(b)}_ms": cuda_ms(
            torch, lambda b=b: E.forward(predictor.params["encoder"], b, cfg,
                                         torch.bfloat16),
            reps=3, warmup=1) for b in (x, x4)})
        pts = torch.tensor([[[0.5, 0.5]]], device=x.device)
        lbl = torch.ones(1, 1, device=x.device)
        enc_ms["decoder_ms"] = cuda_ms(torch, lambda: D.decode_masks(
            predictor.params["decoder"], flash, pts, lbl,
            M.SAM_VIT_B.decoder), reps=5, warmup=1)
        logits = D.decode_masks(predictor.params["decoder"], flash, pts, lbl,
                                M.SAM_VIT_B.decoder)[0][0, 1:].cpu().numpy()
    t = time.perf_counter()
    M._masks_to_original(logits, (cfg.img_size, cfg.img_size),
                         img.shape[:2], cfg.img_size)
    enc_ms["masks_to_original_3_ms"] = (time.perf_counter() - t) * 1e3
    out = {**enc_ms, **bf16_out, "encoder_max_abs_err_b6_vs_einsum": enc_err,
           "encoder_tolerance": 1e-3,
           "encoder_output_max_abs": float(einsum.abs().max()),
           "segment_batch_2_ms_host_clock": batch_ms,
           "segment_batch_vs_predict_iou_max_abs_err": iou_err,
           "segment_batch_vs_predict_mask_agreement": agree}
    log("segment_checks", **out)
    return out


# ------------------------------------------------- the detection path
# The front of the pipeline (ingest → labeling → crop → augment → TinyDet →
# embed → serving). Product photos of 480 x 640, 8 classes of 24.
DET_CLASSES, DET_PER_CLASS, DET_H, DET_W = 8, 24, 480, 640
YOLO_VARIANT, YOLO_SIZE, YOLO_BATCH = "yolov8s", 640, 16
# The YOLO heads on the card against the same module in float64: f32 sums
# in another order (TF32 off, as this script runs), and TF32's 10-bit
# mantissa on every conv input when a user leaves cuDNN's default on.
YOLO_TOL = {"float32": 1e-3, "tf32": 3e-2}  # of the largest head value
TINYDET_EPOCHS, TINYDET_LR = 12, 1e-3


def product_photo(np, rng, color, h=DET_H, w=DET_W):
    """A studio shot: a light, slightly graded background with one
    coloured product and its shadow at a random box; → (image, box)."""
    bh = int(rng.integers(h // 4, h // 2))
    bw = int(rng.integers(w // 5, w // 2))
    y = int(rng.integers(h // 12, h - bh - h // 12))
    x = int(rng.integers(w // 12, w - bw - w // 12))
    ramp = np.linspace(-8, 8, w)[None, :, None]
    img = np.full((h, w, 3), 228.0) + ramp
    img[y + 6:y + bh + 6, x + 6:x + bw + 6] *= 0.8   # shadow
    img[y:y + bh, x:x + bw] = color
    img += rng.integers(0, 10, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), (x, y, x + bw, y + bh)


def detection_tree(np, root, seed: int):
    """``root/original_images/class<c>/IMG_<i>.png`` for 8 classes of 24,
    a camera duplicate ``IMG_0 (2).png`` and a file that does not decode;
    encoded on 8 threads. → {(class, stem): box}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    jobs, boxes = [], {}
    for c in range(DET_CLASSES):
        d = root / "original_images" / f"class{c}"
        d.mkdir(parents=True)
        for i in range(DET_PER_CLASS):
            img, box = product_photo(np, rng, COLORS[c])
            jobs.append((img, d / f"IMG_{i}.png"))
            boxes[(f"class{c}", f"IMG_{i}")] = box
    jobs.append((jobs[0][0], root / "original_images" / "class0" /
                 "IMG_0 (2).png"))
    (root / "original_images" / "class1" / "IMG_99.png").write_bytes(
        b"not a png")

    def save(job):
        Image.fromarray(job[0]).save(job[1], compress_level=1)

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        list(ex.map(save, jobs))
    return boxes


def box_iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
             - inter)
    return inter / max(union, 1e-9)


def label_boxes(port, jpeg_root, boxes):
    """IoU of each image's first label line with its product box."""
    crop = port["crop"]
    out = []
    for (cls, stem), box in boxes.items():
        path = jpeg_root / "original_images" / cls / f"{stem}.txt"
        labels = crop.parse_yolo_label(path) if path.exists() else []
        out.append(box_iou(crop.yolo_to_xyxy(labels[0], DET_W, DET_H), box)
                   if labels else 0.0)
    return out


def yolo_phase(torch, np, port, jpeg_root, work, seed: int) -> dict:
    """YOLOv8s at 640 from seeded weights: the raw heads, the decode and
    the detections of a batch of 16 canvases against the same module in
    float64, predict and postprocess timed on that batch, then
    ``run_labeling`` over a copy of the tree."""
    import shutil

    from PIL import Image

    Y, YD, L = port["yolo_model"], port["yolo_detector"], port["labeling"]
    cfg = Y.VARIANTS[YOLO_VARIANT]
    t0 = time.perf_counter()
    state = Y.params_from_jax(Y.init_params(cfg, seed))
    det = YD.YoloDetector(state, cfg, image_size=YOLO_SIZE,
                          conf_threshold=0.0, max_det=16, device="cuda")
    ref = Y.build_model(state, cfg, device="cuda").double()
    paths = sorted((jpeg_root / "original_images").rglob("*.jpeg"))
    canv = np.stack([L.letterbox(np.asarray(Image.open(p).convert("RGB")),
                                 YOLO_SIZE)[0]
                     for p in paths[:: len(paths) // YOLO_BATCH][:YOLO_BATCH]])
    x = torch.as_tensor(canv, device="cuda").float() / 255.0
    out = {"variant": YOLO_VARIANT, "image_size": YOLO_SIZE,
           "num_classes": cfg.num_classes,
           "parameters": sum(p.numel() for p in det.model.parameters())}
    want = Y.forward_features(ref, x.double())
    wb, wp = Y.predict(ref, x.double())
    ref_dets = Y.postprocess(wb.float().cpu().numpy(),
                             wp.float().cpu().numpy(), 0.0, 0.45, 16)
    for mode, tf32 in (("float32", False), ("tf32", True)):
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            heads = Y.forward_features(det.model, x)
            boxes, probs = Y.predict(det.model, x)
            torch.cuda.synchronize()
            errs = [float((h.double() - w).abs().max() / w.abs().max())
                    for h, w in zip(heads, want)]
            out[f"heads_rel_err_vs_float64_{mode}"] = max(errs)
            out[f"probs_abs_err_vs_float64_{mode}"] = float(
                (probs.double() - wp).abs().max())
            out[f"boxes_abs_err_px_vs_float64_{mode}"] = float(
                (boxes.double() - wb).abs().max())
            out[f"predict_ms_batch{YOLO_BATCH}_{mode}"] = cuda_ms(
                torch, lambda: Y.predict(det.model, x), reps=5, warmup=2)
        finally:
            torch.backends.cudnn.allow_tf32 = before
        if max(errs) > YOLO_TOL[mode] or \
                out[f"probs_abs_err_vs_float64_{mode}"] > YOLO_TOL[mode]:
            raise AssertionError(f"YOLO {mode} vs float64: {out}")
        # Host NMS on the card's scores against the float64 run's: the
        # same detections by class, box (IoU ≥ 0.9) and score (1e-4), not
        # by index (near-ties may order differently).
        got = Y.postprocess(boxes.cpu().numpy(), probs.cpu().numpy(), 0.0,
                            0.45, 16)
        matched = total = 0
        for g, r in zip(got, ref_dets):
            for b, sc, c in zip(g["boxes"], g["scores"], g["classes"]):
                total += 1
                matched += any(cc == c and abs(ss - sc) <= 1e-4 and
                               box_iou(bb, b) >= 0.9
                               for bb, ss, cc in zip(r["boxes"],
                                                     r["scores"],
                                                     r["classes"]))
            kept = list(zip(g["boxes"], g["classes"]))
            if any(ca == cb and box_iou(a, b) > 0.45 + 1e-6
                   for i, (a, ca) in enumerate(kept)
                   for b, cb in kept[i + 1:]):
                raise AssertionError("NMS kept two same-class boxes past "
                                     "the IoU threshold")
            if list(g["scores"]) != sorted(g["scores"], reverse=True):
                raise AssertionError("detections not sorted by score")
        out[f"detections_matching_float64_{mode}"] = f"{matched}/{total}"
        if total != YOLO_BATCH * 16 or \
                (mode == "float32" and matched < 0.75 * total):
            raise AssertionError(f"YOLO detections vs float64: {out}")
    out["tolerance_of_largest_head"] = YOLO_TOL
    b16, p16 = boxes.cpu().numpy(), probs.cpu().numpy()
    out["postprocess_ms_host_batch16_conf0"] = host_ms(
        lambda: Y.postprocess(b16, p16, 0.0, 0.45, 16), reps=3)
    out["postprocess_ms_host_batch16_conf0.25"] = host_ms(
        lambda: Y.postprocess(b16, p16, 0.25, 0.45, 16), reps=3)

    # run_labeling over a copy of the tree; random weights score every
    # class near sigmoid(-5), so the gate is 0 to write labels at all.
    copy = work / "yolo_labels"
    shutil.copytree(jpeg_root, copy)
    t = time.perf_counter()
    res = L.run_labeling(L.LabelConfig(root_dir=str(copy), batch_size=16,
                                       det_size=YOLO_SIZE, conf_threshold=0.0,
                                       max_object_count=4), detector=det)
    out["run_labeling_s"] = time.perf_counter() - t
    n = DET_CLASSES * DET_PER_CLASS
    out["run_labeling_images_per_s"] = n / out["run_labeling_s"]
    lines = [len(p.read_text().splitlines())
             for p in (copy / "original_images").rglob("IMG_*.txt")]
    if res.labeled != n or res.failed or lines != [4] * n:
        raise AssertionError(f"YOLO labeling: {res} {set(lines)}")
    out["labeled"] = res.labeled
    out["seconds"] = time.perf_counter() - t0
    log("detection_yolo", **out)
    del det, ref
    return out


def tinydet_phase(torch, np, port, jpeg_root, seed: int):
    """``fit_detector`` with the default TinyDet on the saliency labels,
    its loss on a labeled batch before and after, one step timed, and its
    boxes on held-out photos."""
    from PIL import Image

    TD, DL, L = port["tinydet"], port["detector_loop"], port["labeling"]
    crop = port["crop"]
    cfg = TD.TinyDetConfig()
    fit_cfg = DL.DetFitConfig(root_dir=str(jpeg_root),
                              epochs=TINYDET_EPOCHS, batch_size=8,
                              learning_rate=TINYDET_LR, seed=seed)
    # One labeled batch (each class's first labeled photo), prepared as
    # fit_detector prepares its batches.
    labeled = sorted((jpeg_root / "original_images").rglob("IMG_*.txt"))
    firsts = {}
    for p in labeled:
        firsts.setdefault(p.parent.name, p.with_suffix(".jpeg"))
    imgs, gts, valid = [], [], []
    for p in firsts.values():
        arr = np.asarray(Image.open(p).convert("RGB"))
        canvas, scale = L.letterbox(arr, cfg.image_size)
        lab = crop.parse_yolo_label(p.with_suffix(".txt"))[0]
        gt = np.zeros((fit_cfg.max_boxes, 4), np.float32)
        gt[0] = np.asarray(crop.yolo_to_xyxy(lab, DET_W, DET_H)) * scale
        imgs.append(canvas.astype(np.float32))
        gts.append(gt)
        valid.append(np.arange(fit_cfg.max_boxes) == 0)
    batch = [torch.as_tensor(np.stack(a), device="cuda")
             for a in (imgs, gts, valid)]

    def batch_loss(params):
        with torch.no_grad():
            return float(TD.loss_fn(params, *batch, cfg)[0])

    init = TD.params_from_jax(TD.init_params(cfg, seed), device="cuda")
    loss0 = batch_loss(init)
    t = time.perf_counter()
    params, metrics = DL.fit_detector(cfg, fit_cfg, device="cuda")
    fit_s = time.perf_counter() - t
    loss1 = batch_loss(params)
    steps = TINYDET_EPOCHS * (len(labeled) // 8)
    out = {"config": {"image_size": cfg.image_size,
                      "channels": list(cfg.channels),
                      "head_dim": cfg.head_dim},
           "epochs": TINYDET_EPOCHS, "steps": steps, "batch": 8,
           "learning_rate": TINYDET_LR, "fit_s": fit_s,
           "fit_images_per_s": steps * 8 / fit_s,
           "loss_on_a_labeled_batch_before": loss0,
           "loss_on_a_labeled_batch_after": loss1,
           "last_step_metrics": metrics}
    if not loss1 < 0.5 * loss0:
        raise AssertionError(f"TinyDet loss did not fall: {out}")
    # One step alone, on a copy of the trained weights.
    step, opt_init = TD.make_train_step(cfg, TINYDET_LR)
    scratch = TD.params_from_jax(params, device="cuda")
    opt = opt_init(scratch)
    out["train_step_ms"] = cuda_ms(
        torch, lambda: step(scratch, opt, *batch), reps=10, warmup=2)

    detector = DL.TinyDetDetector(params, cfg, device="cuda")
    rng = np.random.default_rng(seed + 17)
    held, truth, scales = [], [], []
    for i in range(2 * DET_CLASSES):
        img, box = product_photo(np, rng, COLORS[i % DET_CLASSES])
        canvas, scale = L.letterbox(img, cfg.image_size)
        held.append(canvas)
        truth.append(box)
        scales.append(scale)
    held = np.stack(held)
    boxes, scores = detector(held)
    ious = [box_iou(b[0] / s, t) for b, s, t in zip(boxes, scales, truth)]
    out["heldout_top_box_iou"] = sorted(round(float(v), 3) for v in ious)
    out["heldout_hits_iou_0.5"] = f"{sum(v >= 0.5 for v in ious)}/{len(ious)}"
    if sum(v >= 0.5 for v in ious) < 0.75 * len(ious) or \
            not (scores[:, 0] > 0.25).all():
        raise AssertionError(f"TinyDet on held-out photos: {out}")
    out["decode_ms_batch16"] = cuda_ms(
        torch, lambda: TD.decode(detector.params,
                                 torch.as_tensor(held, device="cuda"), cfg),
        reps=10, warmup=2)
    log("detection_tinydet", **out)
    return out, detector, held


def detection_path(torch, np, port, clip_params, seed: int) -> dict:
    """The front of the pipeline on the card: ingest → YOLOv8s labeling
    (a copy) and saliency labeling → crop → augment → TinyDet training →
    embed_tree of the crops (B1) → RetrievalDetector serving with TinyDet
    as its external detector."""
    import tempfile
    from pathlib import Path

    from PIL import Image

    I, L, C, A = (port["ingest"], port["labeling"], port["crop"],
                  port["augment"])
    t_path = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_det_") as tmp:
        work = Path(tmp)
        t = time.perf_counter()
        boxes = detection_tree(np, work / "dataset_heic", seed + 11)
        write_s = time.perf_counter() - t
        jpeg = work / "dataset_jpeg"
        t = time.perf_counter()
        res = I.run_ingest(I.IngestConfig(src_root=str(work / "dataset_heic"),
                                          dst_root=str(jpeg)))
        n = DET_CLASSES * DET_PER_CLASS
        ingest = {"photos": n, "size": [DET_H, DET_W],
                  "write_png_s": write_s,
                  "ingest_s": time.perf_counter() - t, **vars(res)}
        ingest["ingest_images_per_s"] = n / ingest["ingest_s"]
        if (res.n_converted, res.n_skipped_duplicate, res.n_failed,
                res.n_skipped_existing) != (n, 1, 1, 0):
            raise AssertionError(f"ingest: {res}")
        log("detection_ingest", **ingest)

        yolo = yolo_phase(torch, np, port, jpeg, work, seed)

        t = time.perf_counter()
        lab = L.run_labeling(L.LabelConfig(root_dir=str(jpeg), batch_size=16),
                             device="cuda")
        label_s = time.perf_counter() - t
        ious = label_boxes(port, jpeg, boxes)
        hits = sum(v >= 0.5 for v in ious)
        sal = {"labeled": lab.labeled, "no_object": lab.skipped_no_object,
               "failed": lab.failed, "run_labeling_s": label_s,
               "images_per_s": n / label_s,
               "label_iou_min": min(ious),
               "label_iou_median": float(np.median(ious)),
               "labels_hitting_the_product_iou_0.5": f"{hits}/{n}"}
        log("detection_saliency", **sal)
        if hits < 0.9 * n:
            raise AssertionError(f"saliency labels: {sal}")

        cropped = work / "dataset_cropped"
        t = time.perf_counter()
        cres = C.run_crop(C.CropConfig(src_root=str(jpeg),
                                       dst_root=str(cropped)))
        crop_s = time.perf_counter() - t
        n_lines = sum(len(C.parse_yolo_label(p)) for p in
                      (jpeg / "original_images").rglob("IMG_*.txt"))
        written = list((cropped / "original_images").rglob("*.jpeg"))
        if cres.n_objects != n_lines or len(written) != n_lines:
            raise AssertionError(f"crop: {cres}, {n_lines} label lines")
        aug_src = work / "augment_src"
        for c in range(2):
            d = aug_src / "original_images" / f"class{c}"
            d.mkdir(parents=True)
            for p in sorted((cropped / "original_images" /
                             f"class{c}").iterdir())[:4]:
                (d / p.name).write_bytes(p.read_bytes())
        acfg = A.AugmentConfig(src_root=str(aug_src),
                               dst_root=str(work / "dataset_augmented"),
                               seed=seed)
        t = time.perf_counter()
        ares = A.run_augment(acfg, device="cuda")
        aug_s = time.perf_counter() - t
        want = {f"class{c}/{name}" for c in range(2)
                for p in (aug_src / "original_images" /
                          f"class{c}").iterdir()
                for name in A.variant_names(p.stem, p.suffix, acfg)}
        got = {f"{p.parent.name}/{p.name}" for p in
               (work / "dataset_augmented" / "original_images").rglob("*")
               if p.is_file()}
        if (ares.n_inputs, ares.n_written, ares.n_failed) != (8, 208, 0) or \
                got != want:
            raise AssertionError(f"augment: {ares}")
        # The deterministic ops on one crop: the card equals the CPU.
        one = torch.from_numpy(np.array(
            Image.open(written[0]).convert("RGBA"))).float()
        img = port["image"]
        checks = [(f"brightness_{r}", lambda x, r=r: img.brightness(x, r))
                  for r in img.BRIGHTNESS_RATES]
        checks += [(f"rot{a}", lambda x, a=a: img.rotate_expand(x, float(a)))
                   for a in img.ROTATION_ANGLES]
        checks += [(f"blur{r}", lambda x, r=r: img.gaussian_blur(x, r))
                   for r in (2, 4, 6)]
        differ = [name for name, fn in checks
                  if not torch.equal(fn(one.cuda()).cpu(), fn(one))]
        if differ:
            raise AssertionError(f"augment ops differ card vs CPU: {differ}")
        log("detection_crop_augment", crops=cres.n_objects, crop_s=crop_s,
            crops_per_s=cres.n_objects / crop_s, augment_inputs=ares.n_inputs,
            augment_files=ares.n_written, augment_s=aug_s,
            augment_inputs_per_s=ares.n_inputs / aug_s,
            ops_equal_to_cpu_bit_for_bit=[name for name, _ in checks],
            crop_shape=list(one.shape))

        tiny, tdet, held = tinydet_phase(torch, np, port, jpeg, seed)

        # Embed the crops (B1 in every block) and serve with TinyDet boxes.
        clip_model, embed = port["clip_model"], port["embed"]
        cfg = clip_model.VIT_B_32
        gallery = port["store"].Gallery("detection", dim=cfg.embed_dim,
                                        device="cuda")
        encoder = embed.make_encoder(clip_params, cfg, device="cuda")
        t = time.perf_counter()
        eres = embed.embed_tree(gallery, encoder, embed.EmbedConfig(
            root_dir=str(cropped), batch_size=64))
        embed_s = time.perf_counter() - t
        built = port["delegates"].build_delegates(gallery)
        if eres.total != cres.n_objects or \
                built.n_delegates_written != 4 * DET_CLASSES:
            raise AssertionError(f"embed {eres}, delegates {built}")
        calls = {"ms": []}

        def timed_detector(images):
            t = time.perf_counter()
            res = tdet(images)
            calls["ms"].append((time.perf_counter() - t) * 1e3)
            return res

        server = port["serve"].RetrievalDetector(
            clip_params, gallery, cfg, detector=timed_detector,
            device="cuda")
        classes = [f"class{c}" for c in range(DET_CLASSES)]
        detect_ms, answers = [], []
        for i in range(DET_CLASSES):
            t = time.perf_counter()
            answers.append(server.detect(held[i:i + 1])[0])
            detect_ms.append((time.perf_counter() - t) * 1e3)
        for i, a in enumerate(answers):
            for d in a["detections"]:
                x1, y1, x2, y2 = d["box"]
                if not (0 <= x1 < x2 <= 256 and 0 <= y1 < y2 <= 256) or \
                        d["class_name"] not in classes or \
                        not -1.0 <= d["similarity"] <= 1.0 + 1e-6:
                    raise AssertionError(f"bad detection {d}")
        x = torch.as_tensor(held[:1], device="cuda")
        d2h = host_ms(lambda: x.cpu().numpy(), reps=5)
        correct = sum(a["class_name"] == classes[i]
                      for i, a in enumerate(answers))
        serve_out = {"crops_embedded": eres.total, "embed_tree_s": embed_s,
                     "embed_tree_crops_per_s": eres.total / embed_s,
                     "embed_batches": math.ceil(eres.total / 64),
                     "delegates": built.n_delegates_written,
                     "detect_requests": len(answers),
                     "detect_ms_host_clock": detect_ms,
                     "external_detector_call_ms": calls["ms"],
                     "images_to_host_ms": d2h,
                     "top1_class_matches_photo_colour":
                         f"{correct}/{len(answers)}"}
        log("detection_serve", **serve_out)
    out = {"ingest": ingest, "yolo": yolo, "saliency": sal, "tinydet": tiny,
           "serve": serve_out, "seconds": time.perf_counter() - t_path}
    return out


# ------------------------------------------------------------- the cli path
# The port's own program: every stage through ``cli.main([...])`` in this
# process, from official-layout checkpoints converted by ``convert-weights``.
# Product photos of 480 x 640: 4 classes x (8 original + 4 natural).
CLI_CLASSES, CLI_ORIGINAL, CLI_NATURAL = 4, 8, 4
FIT_SAM_BATCH, FINETUNE_BATCH = 2, 8


def official_clip_state(torch, seed: int) -> dict:
    """A ViT-B/32 CLIP state dict in OpenAI's layout, seeded: the vision
    tower (``visual.*``: 224 px, patch 32, width 768, 12 blocks, 512-d)
    and the text tower's keys (width 512, 12 blocks, 49,408 tokens) that a
    real ``ViT-B-32.pt`` carries beside it. Scales as the JAX package's
    ``init_params``."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape, std):
        return torch.randn(*shape, generator=g) * std

    def blocks(prefix, w, n):
        out = {}
        for i in range(n):
            p = f"{prefix}{i}."
            out.update({
                p + "ln_1.weight": torch.ones(w), p + "ln_1.bias":
                torch.zeros(w),
                p + "attn.in_proj_weight": normal(3 * w, w, std=w ** -0.5),
                p + "attn.in_proj_bias": torch.zeros(3 * w),
                p + "attn.out_proj.weight": normal(w, w, std=w ** -0.5),
                p + "attn.out_proj.bias": torch.zeros(w),
                p + "ln_2.weight": torch.ones(w), p + "ln_2.bias":
                torch.zeros(w),
                p + "mlp.c_fc.weight": normal(4 * w, w, std=w ** -0.5),
                p + "mlp.c_fc.bias": torch.zeros(4 * w),
                p + "mlp.c_proj.weight": normal(w, 4 * w,
                                                std=(2 * w) ** -0.5),
                p + "mlp.c_proj.bias": torch.zeros(w)})
        return out

    W, P, D, T = 768, 32, 512, 512
    sd = {"visual.conv1.weight": normal(W, 3, P, P, std=W ** -0.5),
          "visual.class_embedding": normal(W, std=W ** -0.5),
          "visual.positional_embedding": normal(50, W, std=0.01),
          "visual.ln_pre.weight": torch.ones(W),
          "visual.ln_pre.bias": torch.zeros(W),
          "visual.ln_post.weight": torch.ones(W),
          "visual.ln_post.bias": torch.zeros(W),
          "visual.proj": normal(W, D, std=W ** -0.5),
          **blocks("visual.transformer.resblocks.", W, 12),
          # The text tower, ignored by the conversion.
          "positional_embedding": normal(77, T, std=0.01),
          "text_projection": normal(T, D, std=T ** -0.5),
          "logit_scale": torch.tensor(4.6052),
          "token_embedding.weight": normal(49408, T, std=0.02),
          "ln_final.weight": torch.ones(T), "ln_final.bias": torch.zeros(T),
          **blocks("transformer.resblocks.", T, 12)}
    return sd


def official_sam_b_state(torch, seed: int) -> dict:
    """A SAM-B state dict in segment-anything's layout, seeded: 1024 px,
    patch 16, width 768, 12 blocks, windows of 14, global blocks 2/5/8/11,
    neck 256; the prompt encoder (its mask-downscaling convs included) and
    the mask decoder (256 wide, 2 two-way blocks, 4 mask tokens), its
    upscaling convs' biases drawn nonzero."""
    g = torch.Generator().manual_seed(seed)

    def normal(*shape, std=0.02):
        return torch.randn(*shape, generator=g) * std

    def lin(prefix, cout, cin):
        return {prefix + ".weight": normal(cout, cin, std=cin ** -0.5),
                prefix + ".bias": torch.zeros(cout)}

    def ln(prefix, n):
        return {prefix + ".weight": torch.ones(n),
                prefix + ".bias": torch.zeros(n)}

    d, heads, dd = 768, 12, 256
    sd = {"image_encoder.patch_embed.proj.weight":
          normal(d, 3, 16, 16, std=(3 * 256) ** -0.5),
          "image_encoder.patch_embed.proj.bias": torch.zeros(d),
          "image_encoder.pos_embed": normal(1, 64, 64, d)}
    for i in range(12):
        p = f"image_encoder.blocks.{i}."
        size = 64 if i in (2, 5, 8, 11) else 14
        sd.update({**ln(p + "norm1", d), **lin(p + "attn.qkv", 3 * d, d),
                   **lin(p + "attn.proj", d, d),
                   p + "attn.rel_pos_h": normal(2 * size - 1, d // heads),
                   p + "attn.rel_pos_w": normal(2 * size - 1, d // heads),
                   **ln(p + "norm2", d), **lin(p + "mlp.lin1", 4 * d, d),
                   **lin(p + "mlp.lin2", d, 4 * d)})
    sd.update({"image_encoder.neck.0.weight": normal(dd, d, 1, 1,
                                                     std=d ** -0.5),
               **ln("image_encoder.neck.1", dd),
               "image_encoder.neck.2.weight": normal(dd, dd, 3, 3,
                                                     std=(9 * dd) ** -0.5),
               **ln("image_encoder.neck.3", dd),
               "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix":
               normal(2, dd // 2, std=1.0),
               "prompt_encoder.not_a_point_embed.weight": normal(1, dd),
               "prompt_encoder.no_mask_embed.weight": normal(1, dd),
               "prompt_encoder.mask_downscaling.0.weight": normal(4, 1, 2, 2),
               "prompt_encoder.mask_downscaling.0.bias": torch.zeros(4),
               **ln("prompt_encoder.mask_downscaling.1", 4),
               "prompt_encoder.mask_downscaling.3.weight":
               normal(16, 4, 2, 2),
               "prompt_encoder.mask_downscaling.3.bias": torch.zeros(16),
               **ln("prompt_encoder.mask_downscaling.4", 16),
               "prompt_encoder.mask_downscaling.6.weight":
               normal(dd, 16, 1, 1),
               "prompt_encoder.mask_downscaling.6.bias": torch.zeros(dd),
               "mask_decoder.iou_token.weight": normal(1, dd),
               "mask_decoder.mask_tokens.weight": normal(4, dd)})
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = normal(1, dd)

    def attn(prefix, inner):
        return {**lin(prefix + ".q_proj", inner, dd),
                **lin(prefix + ".k_proj", inner, dd),
                **lin(prefix + ".v_proj", inner, dd),
                **lin(prefix + ".out_proj", dd, inner)}

    for i in range(2):
        p = f"mask_decoder.transformer.layers.{i}."
        sd.update({**attn(p + "self_attn", dd),
                   **attn(p + "cross_attn_token_to_image", dd // 2),
                   **attn(p + "cross_attn_image_to_token", dd // 2),
                   **lin(p + "mlp.lin1", 2048, dd),
                   **lin(p + "mlp.lin2", dd, 2048),
                   **{k: v for n in range(1, 5)
                      for k, v in ln(f"{p}norm{n}", dd).items()}})
    sd.update({**attn("mask_decoder.transformer.final_attn_token_to_image",
                      dd // 2),
               **ln("mask_decoder.transformer.norm_final_attn", dd),
               "mask_decoder.output_upscaling.0.weight":
               normal(dd, dd // 4, 2, 2, std=dd ** -0.5),
               "mask_decoder.output_upscaling.0.bias": normal(dd // 4,
                                                              std=0.1),
               **ln("mask_decoder.output_upscaling.1", dd // 4),
               "mask_decoder.output_upscaling.3.weight":
               normal(dd // 4, dd // 8, 2, 2, std=(dd // 4) ** -0.5),
               "mask_decoder.output_upscaling.3.bias": normal(dd // 8,
                                                              std=0.1)})
    for i in range(4):
        p = f"mask_decoder.output_hypernetworks_mlps.{i}.layers."
        sd.update({**lin(p + "0", dd, dd), **lin(p + "1", dd, dd),
                   **lin(p + "2", dd // 8, dd)})
    p = "mask_decoder.iou_prediction_head.layers."
    sd.update({**lin(p + "0", 256, dd), **lin(p + "1", 256, dd),
               **lin(p + "2", 4, 256)})
    return sd


def cli_tree(np, root, seed: int):
    """``root/{original,natural}_images/class<c>/IMG_<i>.png``: 8 original
    and 4 natural product photos of each of 4 classes. → {(type, class,
    stem): box}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    jobs, boxes = [], {}
    for t, n in (("original", CLI_ORIGINAL), ("natural", CLI_NATURAL)):
        for c in range(CLI_CLASSES):
            d = root / f"{t}_images" / f"class{c}"
            d.mkdir(parents=True)
            for i in range(n):
                img, box = product_photo(np, rng, COLORS[c])
                jobs.append((img, d / f"IMG_{i}.png"))
                boxes[(t, f"class{c}", f"IMG_{i}")] = box
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda j: Image.fromarray(j[0]).save(
            j[1], compress_level=1), jobs))
    return boxes


class CliRecorder:
    """Wraps ``cli.main``: each command's seconds and launches of B1, B5
    and B6, nested commands (e2e's stages) included; output captured."""

    def __init__(self, torch, cli, counts):
        self.torch, self.cli, self.counts = torch, cli, counts
        self.main = cli.main
        self.stages: list[dict] = []
        cli.main = self

    def __call__(self, argv):
        import contextlib

        cmd = next(a for a in argv if not a.startswith("-")
                   and a not in ("cuda", "cpu"))
        before = self.counts()
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = self.main(argv)
        self.torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        after = self.counts()
        self.stages.append({
            "command": cmd, "seconds": seconds,
            "launches": {k: after[k] - before[k] for k in ("B1", "B5", "B6")},
            "stdout_tail": buf.getvalue()[-300:]})
        if rc != 0:
            raise AssertionError(f"rbod {' '.join(argv)} returned {rc}: "
                                 f"{buf.getvalue()[-2000:]}")
        return rc

    def run(self, *argv) -> str:
        """Run one command from the top; its captured output."""
        self(list(argv))
        return self.stages[-1]["stdout_tail"]

    def restore(self):
        self.cli.main = self.main


def run_server_command(rec, module, attr, argv, use):
    """Run a serving CLI command (it blocks in ``serve_forever``) on a
    thread, with ``module.attr`` wrapped to hand back its server; call
    ``use(base_url)``, then shut the server down and join the thread."""
    made, original = [], getattr(module, attr)

    def capture(*a, **kw):
        srv = original(*a, **kw)
        made.append(srv)
        return srv

    setattr(module, attr, capture)
    errors = []

    def target():
        try:
            rec(list(argv))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    try:
        t = time.perf_counter()
        while not made and thread.is_alive() and \
                time.perf_counter() - t < 600:
            time.sleep(0.05)
        if not made:
            raise AssertionError(f"{argv[0]} started no server: {errors}")
        return use(f"http://127.0.0.1:{made[0].server_address[1]}")
    finally:
        setattr(module, attr, original)
        for srv in made:
            srv.shutdown()
            srv.server_close()
        thread.join(timeout=120)
        if thread.is_alive() or errors:
            raise AssertionError(f"{argv[0]} did not stop cleanly: {errors}")


def cli_path(torch, np, port, counts, seed: int) -> dict:
    """The port's ``rbod`` CLI on the card, at full width, every command
    through ``cli.main`` in this process (the device is the default,
    ``cuda``): ``convert-weights`` of seeded official-layout ViT-B/32 and
    SAM-B files; ``e2e --raw`` over 48 product photos; ``fit-sam`` from the
    converted SAM-B and ``segment`` from what it wrote; ``finetune`` (bf16)
    and ``embed`` from what it wrote; ``serve`` answering 3 ``/detect``
    requests; ``segment-web`` (a click, a save, a next); ``review`` and
    ``restore``; ``store``; and ``doctor`` as ``python -m ...cli`` in a
    subprocess."""
    import contextlib
    import csv
    import os
    import tempfile
    from collections import OrderedDict
    from pathlib import Path

    from PIL import Image

    cli, crop = port["cli"], port["crop"]
    # Attention layers: B1 (B5) once per CLIP block, B6 once per SAM block.
    clip_layers = port["clip_model"].VIT_B_32.layers
    sam_layers = port["sam"].SAM_VIT_B.encoder.depth
    out: dict = {}
    t_path = time.perf_counter()
    cwd = os.getcwd()
    rec = CliRecorder(torch, cli, counts)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        work = Path(tmp)
        os.chdir(work)
        try:
            # 1. Seeded official-layout checkpoints, converted.
            t = time.perf_counter()
            clip_sd = official_clip_state(torch, seed + 20)
            torch.save(clip_sd, work / "ViT-B-32.pt")
            sam_sd = OrderedDict(official_sam_b_state(torch, seed + 21))
            torch.save(sam_sd, work / "sam_vit_b_01ec64.pth")
            out["checkpoints"] = {
                "write_s": time.perf_counter() - t,
                "clip_bytes": (work / "ViT-B-32.pt").stat().st_size,
                "sam_bytes": (work / "sam_vit_b_01ec64.pth").stat().st_size}
            rec.run("convert-weights", "--model", "clip", "--input",
                    "ViT-B-32.pt", "--output", "clip_b32")
            rec.run("convert-weights", "--model", "sam", "--input",
                    "sam_vit_b_01ec64.pth", "--output", "sam_b")
            state, config = cli._load_clip("clip_b32")
            want = port["clip_convert"].convert_state_dict(clip_sd)
            if config != port["clip_model"].VIT_B_32 or \
                    not all(torch.equal(state[k], want[k]) for k in want):
                raise AssertionError("convert-weights clip: not the file's "
                                     "ViT-B/32 conversion")
            tree, sam_config = cli._load_sam("sam_b")
            if sam_config != port["sam"].SAM_VIT_B or \
                    "_unused" not in tree["decoder"]:
                raise AssertionError(f"convert-weights sam: {sam_config}")
            # The upscaling convs' biases survive the conversion (C.1).
            for key, i in (("up0_b", 0), ("up1_b", 3)):
                bias = sam_sd[f"mask_decoder.output_upscaling.{i}.bias"]
                if not bias.any() or not torch.equal(
                        tree["decoder"][key].cpu(), bias):
                    raise AssertionError(f"convert-weights sam: {key}")
            del clip_sd, sam_sd, state, want, tree

            # 2. e2e over the raw tree.
            boxes = cli_tree(np, work / "raw", seed + 22)
            e2e_first = len(rec.stages)
            rec.run("e2e", "--raw", "raw", "--clip-checkpoint", "clip_b32",
                    "--sam-checkpoint", "sam_b", "--no-plots")
            stages = rec.stages[e2e_first:]
            results = sorted((work / "results").iterdir())
            with open(next(results[-1].glob("result_*.csv"))) as f:
                rows = list(csv.DictReader(f))
            cases = {r["case"] for r in rows}
            if not {"pre_a", "pre_b", "pre_c"} <= cases:
                raise AssertionError(f"e2e result cases {cases}")
            ious = []
            for (t_, cls, stem), box in boxes.items():
                p = work / "dataset_jpeg" / f"{t_}_images" / cls / \
                    f"{stem}.txt"
                labels = crop.parse_yolo_label(p) if p.exists() else []
                ious.append(box_iou(crop.yolo_to_xyxy(labels[0], DET_W,
                                                      DET_H), box)
                            if labels else 0.0)
            n_photos = len(boxes)
            if min(ious) < 0.5:
                raise AssertionError(f"e2e labels: IoU {sorted(ious)[:4]}")
            n_seg = len(list((work / "dataset_segmented").rglob("*.png")))
            n_aug = len(list((work / "dataset_augmented").rglob("*.png")))
            points = port["persist"].list_snapshots(work / "gallery_store")
            if n_seg != n_photos or n_aug != 26 * n_photos or \
                    points != [("default", 2 * n_photos + n_aug + 96)]:
                raise AssertionError(f"e2e trees: {n_seg} segmented, {n_aug}"
                                     f" augmented, store {points}")
            # Encoder forwards: the segment stage runs batches of 8, the
            # embed stage batches of 64, per type.
            seg_forwards = sum(-(-n // 8) for n in (
                CLI_CLASSES * CLI_ORIGINAL, CLI_CLASSES * CLI_NATURAL))
            embed_batches = sum(
                -(-n // 64) for per_type in (CLI_ORIGINAL, CLI_NATURAL)
                for n in (CLI_CLASSES * per_type, CLI_CLASSES * per_type,
                          26 * CLI_CLASSES * per_type))
            e2e = stages[-1]
            if e2e["launches"]["B6"] != sam_layers * seg_forwards or \
                    e2e["launches"]["B1"] != clip_layers * embed_batches:
                raise AssertionError(f"e2e launches {e2e['launches']} for "
                                     f"{seg_forwards} SAM and "
                                     f"{embed_batches} CLIP forwards")
            out["e2e"] = {
                "photos": n_photos, "size": [DET_H, DET_W],
                "label_iou_min": min(ious),
                "labels_hitting_the_product_iou_0.5":
                    f"{sum(v >= 0.5 for v in ious)}/{n_photos}",
                "segmented": n_seg, "augmented": n_aug,
                "gallery_points": points[0][1],
                "result_rows": {c: sum(r["case"] == c for r in rows)
                                for c in sorted(cases)},
                "sam_forwards": seg_forwards,
                "clip_batches": embed_batches,
                "seconds": e2e["seconds"], "launches": e2e["launches"],
                "stages": [{k: s[k] for k in ("command", "seconds",
                                               "launches")}
                           for s in stages[:-1]]}
            log("cli_e2e", **out["e2e"])

            # 3. fit-sam from the converted SAM-B, then segment from it.
            torch.cuda.reset_peak_memory_stats()
            text = rec.run("fit-sam", "--root", "dataset_segmented",
                           "--sam-checkpoint", "sam_b", "--epochs", "1",
                           "--batch-size", str(FIT_SAM_BATCH), "--out",
                           "sam_ft")
            fit = rec.stages[-1]
            steps = CLI_CLASSES * CLI_ORIGINAL // FIT_SAM_BATCH
            loss = float(text.split("loss=")[1].split()[0])
            iou = float(text.split("IoU=")[1].split()[0])
            if not math.isfinite(loss) or not 0 <= iou <= 1 or \
                    fit["launches"]["B6"] != 0:
                raise AssertionError(f"fit-sam: {text!r} {fit['launches']}")
            few = work / "few" / "original_images" / "class0"
            few.mkdir(parents=True)
            picked = sorted((work / "dataset_cropped" / "original_images" /
                             "class0").iterdir())[:4]
            for p in picked:
                (few / p.name).write_bytes(p.read_bytes())
            text = rec.run("segment", "--src", "few", "--dst", "few_seg",
                           "--sam-checkpoint", "sam_ft")
            if f"segmented={len(picked)} failed=0" not in text or \
                    rec.stages[-1]["launches"]["B6"] != sam_layers:
                raise AssertionError(f"segment from fit-sam: {text!r}")
            out["fit_sam"] = {
                "batch": FIT_SAM_BATCH, "steps": steps, "loss": loss,
                "best_token_iou": iou, "seconds": fit["seconds"],
                "seconds_per_step": fit["seconds"] / steps,
                "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9,
                "segment_from_it_s": rec.stages[-1]["seconds"]}
            log("cli_fit_sam", **out["fit_sam"])

            # 4. finetune (bf16), then embed from what it wrote.
            text = rec.run("finetune", "--root", "dataset_cropped",
                           "--clip-checkpoint", "clip_b32", "--epochs", "1",
                           "--batch-size", str(FINETUNE_BATCH), "--out",
                           "clip_ft", "--dp", "1", "--tp", "1")
            ft = rec.stages[-1]
            ft_loss = float(text.split("loss=")[1].split()[0])
            ft_steps = CLI_CLASSES * CLI_ORIGINAL // FINETUNE_BATCH
            if "dp=1 tp=1" not in text or \
                    ft["launches"]["B5"] != clip_layers * ft_steps or \
                    ft["launches"]["B1"] != clip_layers * ft_steps:
                raise AssertionError(f"finetune: {text!r} {ft['launches']}")
            text = rec.run("embed", "--root", "dataset_cropped", "--store",
                           "gs_ft", "--collection", "ft", "--clip-checkpoint",
                           "clip_ft")
            n_crops = CLI_CLASSES * CLI_ORIGINAL
            if f"embedded={n_crops} failed=0" not in text:
                raise AssertionError(f"embed from finetune: {text!r}")
            # A mesh past the card count: the device-count error, exit 2.
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = rec.main(["finetune", "--root", "dataset_cropped",
                               "--clip-checkpoint", "clip_b32", "--dp",
                               str(torch.cuda.device_count() + 1)])
            if rc != 2 or "do not multiply" not in err.getvalue():
                raise AssertionError(f"finetune past the cards: {rc} "
                                     f"{err.getvalue()[-2000:]!r}")
            out["finetune"] = {
                "steps": ft_steps, "batch": FINETUNE_BATCH,
                "loss": ft_loss,
                "seconds": ft["seconds"], "launches": ft["launches"],
                "embed_s": rec.stages[-1]["seconds"],
                "past_the_cards": err.getvalue().strip()}
            log("cli_finetune", **out["finetune"])

            # 5. serve: 3 /detect requests against e2e's collection.
            rng = np.random.default_rng(seed + 23)
            classes = [f"class{c}" for c in range(CLI_CLASSES)]
            uploads = []
            for c in range(3):
                buf = io.BytesIO()
                Image.fromarray(product_photo(np, rng, COLORS[c])[0]).save(
                    buf, "JPEG", quality=95)
                uploads.append(buf.getvalue())

            def detect(base):
                answers = []
                for data in uploads:
                    t = time.perf_counter()
                    req = urllib.request.Request(base + "/detect",
                                                 data=data, method="POST")
                    with urllib.request.urlopen(req, timeout=300) as r:
                        answers.append((json.loads(r.read()),
                                        (time.perf_counter() - t) * 1e3))
                return answers

            answers = run_server_command(
                rec, port["serve"], "serve_http",
                ["serve", "--clip-checkpoint", "clip_b32", "--host",
                 "127.0.0.1", "--port", "0", "--warm"], detect)
            for a, _ in answers:
                for d in a["detections"]:
                    if d["class_name"] not in classes or not \
                            -1.0 <= d["similarity"] <= 1.0 + 1e-6:
                        raise AssertionError(f"serve: bad detection {d}")
            out["serve"] = {
                "requests": len(answers),
                "detect_ms_client": [ms for _, ms in answers],
                "top1": [a["class_name"] for a, _ in answers],
                "seconds": rec.stages[-1]["seconds"],
                "launches": rec.stages[-1]["launches"]}
            log("cli_serve", **out["serve"])

            # 6. segment-web: a click, a save and a next over HTTP.
            web_dir = work / "dataset_cropped" / "original_images" / \
                "class1"

            def click_save_next(base):
                with urllib.request.urlopen(base + "/img/current",
                                            timeout=300) as r:
                    r.read()
                t = time.perf_counter()
                res = http_json("POST", base + "/api/click",
                                {"x": 40, "y": 30})
                click_ms = (time.perf_counter() - t) * 1e3
                saved = http_json("POST", base + "/api/save",
                                  {"mask": res["best"]})
                nxt = http_json("POST", base + "/api/next", {})
                return res, saved, nxt, click_ms

            res, saved, nxt, click_ms = run_server_command(
                rec, port["segment_web"], "serve",
                ["segment-web", "--dir", str(web_dir), "--sam-checkpoint",
                 "sam_b", "--host", "127.0.0.1", "--port", "0"],
                click_save_next)
            if len(res["scores"]) != 3 or nxt["pos"] != 1 or \
                    not Path(saved["saved"]).exists() or \
                    rec.stages[-1]["launches"]["B6"] != sam_layers:
                raise AssertionError(f"segment-web: {res} {saved} {nxt}")
            out["segment_web"] = {
                "scores": res["scores"], "click_ms": click_ms,
                "saved": Path(saved["saved"]).name,
                "seconds": rec.stages[-1]["seconds"],
                "launches": rec.stages[-1]["launches"]}
            log("cli_segment_web", **out["segment_web"])

            # 7. review's headless commands, and restore.
            texts = [rec.run("review", cmd, *extra) for cmd, *extra in (
                ("status",), ("render", "--out", "preview.png"),
                ("select", "--box", "0"), ("redetect",), ("next",),
                ("manual",))]
            restore = rec.run("restore")
            if f"items={CLI_CLASSES * CLI_ORIGINAL}" not in texts[0] or \
                    not (work / "preview.png").exists() or \
                    texts[2].strip() != "ok" or \
                    not texts[3].startswith("0: (") or \
                    "moved to dataset_manual" not in texts[5] or \
                    "restored=0 skipped=1" not in restore:
                raise AssertionError(f"review: {texts} {restore}")
            out["review"] = {"seconds": sum(
                s["seconds"] for s in rec.stages[-7:]),
                "redetect": texts[3].strip()}

            # 8. store list and count.
            listed = rec.run("store", "list")
            counted = rec.run("store", "count", "--name", "default")
            if listed.strip() != f"default\t{points[0][1]}" or \
                    counted.strip() != str(points[0][1]):
                raise AssertionError(f"store: {listed!r} {counted!r}")

            # 9. doctor through the module entry, in a subprocess.
            checkout = str(Path(__file__).resolve().parent)
            env = {**os.environ, "PYTHONPATH": os.pathsep.join(
                [checkout] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p])}
            t = time.perf_counter()
            doc = subprocess.run(
                [sys.executable, "-m",
                 "retrieval_based_object_detection_tpu_torch.cli", "doctor"],
                cwd=work, env=env, capture_output=True, text=True,
                timeout=600)
            out["doctor"] = {"seconds": time.perf_counter() - t,
                             "rc": doc.returncode,
                             "b1_check": [line.strip() for line in
                                          doc.stdout.splitlines()
                                          if "B1 kernel" in line]}
            if doc.returncode != 0 or "all checks passed" not in doc.stdout:
                raise AssertionError(f"doctor: {doc.stdout[-2000:]}"
                                     f"{doc.stderr[-2000:]}")
            log("cli_rest", serve=out["serve"]["seconds"],
                review=out["review"], doctor=out["doctor"])
        finally:
            os.chdir(cwd)
            rec.restore()
    out["commands"] = [{k: s[k] for k in ("command", "seconds", "launches")}
                       for s in rec.stages]
    out["seconds"] = time.perf_counter() - t_path
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import tempfile
    from pathlib import Path

    try:
        import numpy as np
        import torch
        import torch.nn.functional as F

        from retrieval_based_object_detection_tpu_torch import native
        from retrieval_based_object_detection_tpu_torch.cli import (
            main as cli,
        )
        from retrieval_based_object_detection_tpu_torch.gallery import (
            capacity, client, persist, router, schema, search, server,
            store,
        )
        from retrieval_based_object_detection_tpu_torch.models.clip import (
            convert as clip_convert, model as clip_model, preprocess,
        )
        from retrieval_based_object_detection_tpu_torch.models.detector import (
            saliency, tinydet,
        )
        from retrieval_based_object_detection_tpu_torch.models.sam import (
            decoder as sam_decoder, encoder as sam_encoder, model as sam,
        )
        from retrieval_based_object_detection_tpu_torch.ops import (
            attention as A, clip_attention as CA, cuda_lib, image,
            int4_scan as S4, int8_scan as S, medoid as M,
        )
        from retrieval_based_object_detection_tpu_torch.parallel import mesh
        from retrieval_based_object_detection_tpu_torch.models.yolo import (
            detector as yolo_detector, model as yolo_model,
        )
        from retrieval_based_object_detection_tpu_torch.pipelines import (
            analysis, augment, crop, delegates, embed, experiments, ingest,
            labeling, migrate, segment, segment_web, serve,
        )
        from retrieval_based_object_detection_tpu_torch.train import (
            detector_loop, loop as train_loop, train,
        )
        from retrieval_based_object_detection_tpu_torch.utils import (
            checkpoint, loader, tree,
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
            "loader": loader, "clip_attention": CA, "train": train,
            "train_loop": train_loop, "checkpoint": checkpoint, "sam": sam,
            "sam_encoder": sam_encoder, "sam_decoder": sam_decoder,
            "segment": segment, "persist": persist, "capacity": capacity,
            "native": native, "analysis": analysis, "server": server,
            "client": client, "router": router, "migrate": migrate,
            "mesh": mesh, "ingest": ingest, "labeling": labeling,
            "crop": crop, "augment": augment, "yolo_model": yolo_model,
            "yolo_detector": yolo_detector, "tinydet": tinydet,
            "detector_loop": detector_loop, "cli": cli,
            "clip_convert": clip_convert, "segment_web": segment_web}

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
        torch=torch.__version__, cuda=torch.version.cuda,
        peak_ops=PEAK_OPS, f32_cuda_core_ops=F32_CUDA_CORE_OPS,
        hbm_bytes_per_s=HBM_BYTES_PER_S)

    t = time.perf_counter()
    libraries = [CA.KERNEL, S.KERNEL, S4.KERNEL, M.KERNEL, A.KERNEL]
    cuda_lib.build_all(libraries)
    log("build", seconds=time.perf_counter() - t,
        libraries=[lib.path.name for lib in libraries])
    hmma_phase([A.KERNEL, CA.KERNEL, M.KERNEL, S4.KERNEL, S.KERNEL])

    attn = attention_phase(torch, F, CA, args.seed)
    attn_bwd = attention_bwd_phase(torch, CA, args.seed)
    flash = flash_phase(torch, F, A, args.seed)
    torch.cuda.empty_cache()
    scan = scan_phase(torch, S, args.seed)
    torch.cuda.empty_cache()
    int4 = int4_phase(torch, S4, args.seed)
    torch.cuda.empty_cache()
    med = medoid_phase(torch, M, args.seed)
    torch.cuda.empty_cache()

    def zero_counts():
        for lib in libraries:
            lib.reset_counts()

    def read_counts():
        return {"B1": CA.KERNEL.counts["clip_attention_fwd"],
                "B2": S.KERNEL.launches, "B3": S4.KERNEL.launches,
                "B4": M.KERNEL.launches,
                "B5": CA.KERNEL.counts["clip_attention_bwd"],
                "B6": A.KERNEL.counts[A.B6], "B7": A.KERNEL.counts[A.B7]}

    by_path = {}
    # The serving path: launch counts from here to its end only.
    zero_counts()
    serving, detector, params = serving_phase(torch, np, port, args.seed)
    _, big, queries, picks = gallery_phase(torch, np, port, args.seed)
    by_path["serving"] = read_counts()
    encodes = serving["embed_batches"] + serving["dispatches"]
    if by_path["serving"]["B1"] < 12 * encodes or by_path["serving"]["B2"] < 1:
        raise AssertionError(f"kernel launches {by_path['serving']} for "
                             f"{encodes} encodes and the int8 searches")
    breakdown_phase(torch, np, port, detector, args.seed)
    del detector

    # The detection path (the front of the pipeline): launch counts from
    # here to its end only.
    zero_counts()
    det_out = detection_path(torch, np, port, params, args.seed)
    by_path["detection"] = launches = read_counts()
    encodes = det_out["serve"]["embed_batches"] + \
        det_out["serve"]["detect_requests"]
    if launches["B1"] < 12 * encodes:
        raise AssertionError(f"detection launches {launches} for "
                             f"{encodes} encodes")
    log("detection_path", seconds=det_out["seconds"], launches=launches)
    torch.cuda.empty_cache()

    # The offline path: launch counts from here to its end only.
    zero_counts()
    offline = experiment_phase(torch, np, port, params, args.seed)
    gallery_int4_phase(torch, np, port, big, queries, picks)
    by_path["offline"] = launches = read_counts()
    encodes = offline["encode_batches"] + offline["timing_encodes"]
    if launches["B1"] != 12 * encodes or \
            launches["B4"] != offline["groups_over_threshold"] \
            or launches["B3"] < 1:
        raise AssertionError(
            f"offline kernel launches {launches} for {encodes} encodes, "
            f"{offline['groups_over_threshold']} large groups and the int4 "
            "searches")

    # The gallery path (deletes, persistence, the capacity tier): launch
    # counts from here to its end only.
    t_gallery = time.perf_counter()
    zero_counts()
    tombstones_phase(torch, np, port, big, queries, picks, args.seed)
    persist_phase(torch, np, port, big, queries)
    cap_out, view, cap_q = capacity_phase(torch, np, port, big, queries,
                                          args.seed)
    by_path["gallery"] = launches = read_counts()
    if launches["B2"] < 1 or launches["B3"] < 1:
        raise AssertionError(f"gallery path launches {launches}")
    log("gallery_path", seconds=time.perf_counter() - t_gallery,
        launches=launches)
    cap_b3 = capacity_kernel_timing(torch, S4, search, view, cap_q)
    del view, cap_q
    torch.cuda.empty_cache()

    # The service path and the sharded path, over the same gallery
    # compacted: launch counts from the start of each to its end only.
    big.compact()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t = time.perf_counter()
        zero_counts()
        _, reloaded = service_path(torch, np, port, big, queries,
                                   Path(tmp), args.seed)
        by_path["service"] = launches = read_counts()
        if launches["B2"] < 1 or launches["B3"] < 1:
            raise AssertionError(f"service path launches {launches}")
        log("service_path", seconds=time.perf_counter() - t,
            launches=launches)
        torch.cuda.empty_cache()
        t = time.perf_counter()
        zero_counts()
        sharded_out, shard_view = sharded_path(torch, np, port, big, queries,
                                               Path(tmp), reloaded, args.seed)
        by_path["sharded"] = launches = read_counts()
        if launches["B2"] < 4 or launches["B3"] < 4:
            raise AssertionError(f"sharded path launches {launches}")
        log("sharded_path", seconds=time.perf_counter() - t,
            launches=launches, max_memory_allocated_gb=
            torch.cuda.max_memory_allocated() / 1e9)
    shard_b = shard_kernel_checks(torch, port, shard_view, queries)
    del big, shard_view
    torch.cuda.empty_cache()

    # The training path: launch counts from here to its end only.
    zero_counts()
    training = training_path(torch, np, port, args.seed)
    by_path["training"] = launches = read_counts()
    if launches["B1"] != 12 * training["steps"] or \
            launches["B5"] != 12 * training["steps"]:
        raise AssertionError(f"training launches {launches} for "
                             f"{training['steps']} steps")
    training_checks(torch, np, port, args.seed)
    torch.cuda.empty_cache()

    # The mesh_training path (dp × tp on cuda:0 listed four times): launch
    # counts from here to its end only.
    zero_counts()
    mesh_out = mesh_training_path(torch, np, port, args.seed)
    by_path["mesh_training"] = launches = read_counts()
    want = mesh_out["expected_launches"]
    if launches["B1"] != want["B1"] or launches["B5"] != want["B5"]:
        raise AssertionError(f"mesh_training launches {launches}, "
                             f"expected {want}")
    mesh_training_checks(torch, np, port, args.seed)
    torch.cuda.empty_cache()

    # The segment path: launch counts from here to its end only.
    zero_counts()
    seg_out, predictor, img = segment_path(torch, np, port, args.seed)
    by_path["segment"] = launches = read_counts()
    if launches["B6"] != 12 * seg_out["encoder_forwards"]:
        raise AssertionError(f"segment launches {launches} for "
                             f"{seg_out['encoder_forwards']} encoder "
                             "forwards")
    segment_checks(torch, np, port, predictor, img, args.seed)
    del predictor
    torch.cuda.empty_cache()

    # The cli path (the port's own program): launch counts from here to
    # its end only.
    zero_counts()
    cli_out = cli_path(torch, np, port, read_counts, args.seed)
    by_path["cli"] = launches = read_counts()
    if min(launches["B1"], launches["B5"], launches["B6"]) < 1:
        raise AssertionError(f"cli path launches {launches}")
    log("cli_path", seconds=cli_out["seconds"], launches=launches,
        commands=cli_out["commands"])
    torch.cuda.empty_cache()
    attention_bwd_library_phase(torch, F, CA, args.seed, attn_bwd)

    def row(name, kid, source, replaces, res, shape, **extra):
        paths = {path: counts[kid] for path, counts in by_path.items()}
        return {"name": name, "id": kid, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(paths.values()),
                "launches_by_path": paths,
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": res["library_ms"],
                "shape": shape, **extra}

    def f32(res):
        return {k: res["float32"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}

    kernels = [
        row("clip_attention_fwd", "B1", ATTN_SOURCE, ATTN_REPLACES,
            attn["bfloat16"], [64, 50, 2304], dtype="bfloat16",
            float32=f32(attn)),
        row("int8_scan", "B2", SCAN_SOURCE, SCAN_REPLACES, scan,
            [16, 1 << 20, 512], library=scan["library"],
            library_full_ms=scan["library_full_ms"],
            bf16_matmul_ms=scan["bf16_matmul_ms"],
            sharded={"shape": shard_b["shape"], "shards": shard_b["shards"],
                     "max_abs_err": shard_b["max_abs_err"]["B2"],
                     "ms_one_shard": shard_b["b2_ms_one_shard"],
                     "bound_ms_one_shard": shard_b["b2_bound_ms_one_shard"],
                     "library_ms_one_shard": shard_b["int_mm_ms_one_shard"],
                     "library_full_ms_one_shard": shard_b[
                         "int_mm_full_ms_one_shard"],
                     "launches_per_search": sharded_out[
                         "launches_per_search"]["sharded_int8"]["B2"]}),
        row("int4_scan", "B3", INT4_SOURCE, INT4_REPLACES, int4,
            [16, 1 << 20, 512],
            capacity_10m={**cap_b3, "launches_per_search":
                          cap_out["b3_launches_per_search"]},
            sharded={"shape": shard_b["shape"], "shards": shard_b["shards"],
                     "max_abs_err": shard_b["max_abs_err"]["B3"],
                     "ms_one_shard": shard_b["b3_ms_one_shard"],
                     "bound_ms_one_shard": shard_b["b3_bound_ms_one_shard"],
                     "launches_per_search": sharded_out[
                         "launches_per_search"]["sharded_int4"]["B3"]}),
        row("medoid_sums", "B4", MEDOID_SOURCE, MEDOID_REPLACES, med,
            [12_000, 512]),
        row("clip_attention_bwd", "B5", ATTN_SOURCE, BWD_REPLACES,
            attn_bwd["bfloat16"], [64, 50, 2304], dtype="bfloat16",
            float32=f32(attn_bwd)),
        row("flash_attention_2d_bias_fwd", "B6", FLASH_SOURCE,
            FLASH2D_REPLACES, flash["b6_global"]["float32"],
            flash["b6_global"]["shape"], dtype="float32",
            bfloat16={k: flash["b6_global"]["bfloat16"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            windowed={"shape": flash["b6_windowed"]["shape"],
                      **{dt: {k: flash["b6_windowed"][dt][k] for k in (
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms")}
                         for dt in ("float32", "bfloat16")}}),
        row("flash_attention_fwd", "B7", FLASH_SOURCE, FLASH_REPLACES,
            flash["b7"]["float32"], flash["b7"]["shape"], dtype="float32",
            bfloat16={k: flash["b7"]["bfloat16"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            note="no caller on any path in either package; held against "
                 "its plain version only"),
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
