#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: its serving, offline, training and
segment paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from ``csrc/`` (one nvcc per source, all
started together), counts the tensor-core instructions of each
tensor-core kernel (B1, B3, B4, B5, B6, B7), and holds each kernel against its
plain PyTorch version at the shapes its path gives it. Then it drives
four paths through the calls a user makes, at full width from seeded
weights:

- serving: a few hundred synthetic crops are embedded into a Gallery,
  ``build_delegates`` runs, ``serve_http`` answers concurrent
  ``POST /detect`` requests, and a 1,048,576 x 512 gallery answers
  ``Gallery.search(exact=False)`` through the int8 scan;
- offline: ``embed_tree`` over a synthetic dataset tree, 12,000 crops of
  one class through ``embed_arrays`` (a group past the blocked-medoid
  threshold), ``build_delegates``, ``run_experiments`` in both match
  modes writing CSV/npy, and ``search(method="int4")`` on the 1M-row
  gallery;
- training: ``fit`` fine-tunes ViT-B/32 (bf16 compute, f32 weights) for 12
  steps of 64 on a colour-class tree with checkpoints, then resumes for 6
  more under the cosine schedule; one f32 step's gradients are held
  against the plain attention core on the card;
- segment: SAM-B (1024 px) ``run_auto_segment`` over a small tree with a
  file that does not decode, then ``set_image`` and ``predict``; the
  encoder is held against its einsum attention (f32 and bf16) and
  ``segment_batch``
  against per-image ``predict`` on the card.

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


def profiler_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call as ``torch.profiler`` sums it over the
    kernels and copies of ``reps`` calls: for work that a CUDA graph cannot
    capture (autograd's backward runs on its own thread) and that is shorter
    than the host's cost of calling it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    if total_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total_us / reps / 1e3


# The tensor-core kernels of each library, by their mangled names, with the
# number of instantiations and the instruction to count: the flash kernels
# (B6/B7: f32 and bf16 x head width 32/64/128 x bias), the attention core's
# forward and backward (B1, B5: f32 and bf16 x head width 32/64/128), the
# medoid's tile kernel (B4) and the int4 scan (B3, on the int8 tensor cores).
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
        from retrieval_based_object_detection_tpu_torch.models.sam import (
            decoder as sam_decoder, encoder as sam_encoder, model as sam,
        )
        from retrieval_based_object_detection_tpu_torch.ops import (
            attention as A, clip_attention as CA, cuda_lib, image,
            int4_scan as S4, int8_scan as S, medoid as M,
        )
        from retrieval_based_object_detection_tpu_torch.pipelines import (
            delegates, embed, experiments, segment, serve,
        )
        from retrieval_based_object_detection_tpu_torch.train import (
            loop as train_loop, train,
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
            "segment": segment}

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
    hmma_phase([A.KERNEL, CA.KERNEL, M.KERNEL, S4.KERNEL])

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
    del big
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
            [16, 1 << 20, 512]),
        row("int4_scan", "B3", INT4_SOURCE, INT4_REPLACES, int4,
            [16, 1 << 20, 512]),
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
