#!/usr/bin/env python3
"""Time and check the tensor-core kernels B1, B3, B4 and B5, and variants of
them, on one NVIDIA GPU.

    python3 retrieval_based_object_detection_tpu_torch/csrc/variants.py time [--root DIR]
    python3 retrieval_based_object_detection_tpu_torch/csrc/variants.py variants [--only b5]
    python3 retrieval_based_object_detection_tpu_torch/csrc/variants.py ptxas

``time`` prints one JSON line for the checkout at ``--root`` (default: the
one this file lies in): B1 and B5 at [64, 50, 2304] in bf16 and f32 (device
time from a CUDA graph's replay; B1 also by events around eager calls) beside
``scaled_dot_product_attention`` and its backward (by ``torch.profiler``,
as B5 is a second time: autograd's backward cannot be captured), B3 at 16 x 1,048,576 x
512, B4 at 12,000 x 512 beside ``torch.cdist(x, x).sum(1)``, and one bf16
training step of 64 crops at ViT-B/32. To compare
two commits on one card, unpack the other one somewhere and run ``time`` for
each root in turns, one right after the other.

``ptxas`` prints what ``nvcc -Xptxas -v`` says of each kernel of
``clip_attention.cu`` and ``int4_scan.cu``: registers, spills, shared memory.

``variants`` builds copies of ``clip_attention.cu``, ``medoid.cu`` and
``int4_scan.cu`` with one thing changed each (string edits of the sources,
built into ``build/variants/``), and prints for each its distance from a
float64 reference (B3: whether it equals the plain scan) and its time beside
the committed kernels':

- ``chain``: the running sums left in the tensor core's accumulator
  (``mma_3xtf32`` where the sources call ``mma_3xtf32_rn``);
- ``nosplit``: no hi/lo split (wrong results; what a free split would gain);
- ``onemma``: one TF32 product of the three, no split (wrong results; what
  the tensor-core work costs);
- ``bounds1``: B4's tile kernel without its two-blocks-an-SM launch bound;
- ``bwd1``, ``bwd4``: B5 with no launch bound on its registers, or held to
  4 blocks an SM (the source holds f32 to 3);
- ``once``: B5 with p and dl rounded to bf16 once, no hi/lo split (another
  function; what the second mma of each pair costs);
- ``sm2``, ``sm3``, ``sm6``, ``sm8``: B3 with 2, 3, 6 or 8 blocks an SM in
  place of 4.

Both need a GPU and nvcc and fail without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]

SPLIT = """  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
"""
THREE = """  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
"""
NOSPLIT = "  hi = __float_as_uint(x);\n  lo = 0u;\n"
# name -> edits of (mma.cuh, the .cu sources), each (old, new)
VARIANTS = {
    "committed": ([], []),
    "chain": ([], [("mma_3xtf32_rn(", "mma_3xtf32(")]),
    "nosplit": ([(SPLIT, NOSPLIT)], []),
    "onemma": ([(SPLIT, NOSPLIT),
                (THREE, "  mma_tf32(d, ah, bh0, bh1);\n")], []),
    "bounds1": ([], [("__launch_bounds__(kThreads, 2)",
                      "__launch_bounds__(kThreads)")]),
    "bwd1": ([], [("kD <= 64) ? 3 : 1", "kD <= 64) ? 1 : 1")]),
    "bwd4": ([], [("kFwdThreads, kBwdBlocks<T, kD>)", "kFwdThreads, 4)")]),
    "once": ([], [("kNT, true>(", "kNT, false>("),
                  ("2, true>(", "2, false>(")]),
    "sm3": ([], [("kBlocksPerSm = 4", "kBlocksPerSm = 3")]),
    "sm6": ([], [("kBlocksPerSm = 4", "kBlocksPerSm = 6")]),
    "sm8": ([], [("kBlocksPerSm = 4", "kBlocksPerSm = 8")]),
    "sm2": ([], [("kBlocksPerSm = 4", "kBlocksPerSm = 2")]),
}
SOURCES = ("clip_attention", "medoid", "int4_scan")
NVCC = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC"]


def events_ms(torch, fn, reps=10):
    for _ in range(2):
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


def graph_ms(torch, fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return events_ms(torch, graph.replay, reps=1) / reps


def profiler_ms(torch, fn, reps=20):
    """Device time of one call as ``torch.profiler`` sums it over the kernels
    and copies of ``reps`` calls: for work that cannot be captured in a CUDA
    graph (autograd's backward runs on its own thread)."""
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
        raise RuntimeError("the profiler recorded no device time")
    return total_us / reps / 1e3


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def unit_rows(torch, n=12_000, d=512, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.nn.functional.normalize(torch.randn(n, d, generator=g),
                                         dim=1).cuda()


def near_duplicates(torch, n, seed):
    """One unit centre plus 1e-3 noise, 512-d, and the float64 direct
    distance sums of the f32 rows."""
    g = torch.Generator().manual_seed(seed)
    centre = torch.nn.functional.normalize(
        torch.randn(512, generator=g, dtype=torch.float64), dim=0)
    x = (centre + 1e-3 * torch.randn(n, 512, generator=g,
                                     dtype=torch.float64)).float().cuda()
    ref = torch.cdist(x.double(), x.double(),
                      compute_mode="donot_use_mm_for_euclid_dist").sum(1)
    return x, ref


def attention_float64(qkv, heads):
    B, T, W3 = qkv.shape
    W = W3 // 3
    q, k, v = (t.double().view(B, T, heads, W // heads).transpose(1, 2)
               for t in qkv.split(W, dim=-1))
    p = (q @ k.transpose(-1, -2) * (W // heads) ** -0.5).softmax(-1)
    return (p @ v).transpose(1, 2).reshape(B, T, W)


def time_checkout(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from retrieval_based_object_detection_tpu_torch.ops import (
        clip_attention as CA, cuda_lib, int4_scan as S4, medoid as M,
    )
    cuda_lib.build_all([CA.KERNEL, M.KERNEL, S4.KERNEL])
    B, T, H, D = 64, 50, 12, 64
    gen = torch.Generator().manual_seed(0)
    base = torch.randn(B, T, 3 * H * D, generator=gen).cuda()
    dbase = torch.randn(B, T, H * D, generator=gen).cuda()
    out = {"root": str(root), "card": card()}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qkv, dout = base.to(dtype), dbase.to(dtype)
        q, k, v = (t.view(B, T, H, D).transpose(1, 2)
                   for t in qkv.split(H * D, dim=-1))
        out[f"b5_{name}_ms"] = graph_ms(
            torch, lambda: CA.clip_attention_core_bwd(qkv, dout, H))
        out[f"b5_{name}_profiler_ms"] = profiler_ms(
            torch, lambda: CA.clip_attention_core_bwd(qkv, dout, H))
        out[f"sdpa_bwd_{name}_ms"] = sdpa_backward_ms(torch, F, qkv, dout, H)
        out[f"b1_{name}_ms"] = graph_ms(
            torch, lambda: CA.clip_attention_core(qkv, H))
        out[f"b1_{name}_eager_ms"] = events_ms(
            torch, lambda: CA.clip_attention_core(qkv, H), reps=20)
        out[f"sdpa_{name}_ms"] = graph_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v))
    x = unit_rows(torch)
    out["b4_ms"] = events_ms(torch, lambda: M.pairwise_distance_sums(x))
    out["cdist_ms"] = events_ms(torch, lambda: torch.cdist(x, x).sum(1))
    del x
    args = int4_case(torch)
    got = S4.int4_scan_scores(*args)
    out["b3_equals_plain"] = bool(torch.equal(
        got, S4.int4_scan_scores_plain(*args)))
    del got
    out["b3_ms"] = events_ms(torch, lambda: S4.int4_scan_scores(*args),
                             reps=20)
    del args
    out["train_step_bf16_64_ms"] = train_step_ms(torch)
    return out


def train_step_ms(torch):
    """One bf16 training step of 64 crops at full ViT-B/32 width (B1 and B5
    12 times each), events around 10 steps: what the attention kernels'
    times are a part of. Mostly the host launching small kernels, so it
    follows the host's load; compare checkouts only in turns in one call."""
    from retrieval_based_object_detection_tpu_torch.models.clip import (
        model as clip_model,
    )
    from retrieval_based_object_detection_tpu_torch.train import train as T

    tcfg = T.TrainConfig(num_classes=8)
    model, opt = T.init_state(clip_model.VIT_B_32, tcfg, seed=0,
                              device="cuda")
    step = T.make_train_step(tcfg)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64, 224, 224, 3, generator=g).cuda()
    y = torch.randint(0, 8, (64,), generator=g).cuda()
    return events_ms(torch, lambda: step(model, opt, x, y), reps=10)


def sdpa_backward_ms(torch, F, qkv, dout, heads):
    """Device time of the backward alone of SDPA on the split q, k, v, by
    the profiler."""
    B, T, W3 = qkv.shape
    D = W3 // 3 // heads
    x = qkv.clone().requires_grad_(True)
    q, k, v = (t.view(B, T, heads, D).transpose(1, 2)
               for t in x.split(W3 // 3, dim=-1))
    sdpa = F.scaled_dot_product_attention(q, k, v)
    d_heads = dout.view(B, T, heads, D).transpose(1, 2)
    return profiler_ms(torch, lambda: torch.autograd.grad(
        sdpa, (q, k, v), d_heads, retain_graph=True))


def int4_case(torch, Q=16, N=1 << 20, D=512, seed=4):
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(-127, 128, (Q, D), generator=g, dtype=torch.int8)
    q[:, D // 2:] //= 3
    packed = torch.randint(-128, 128, (N, D // 2), generator=g,
                           dtype=torch.int8)
    scales = torch.rand(N, generator=g) * 0.2 + 1e-3
    pen = torch.where(torch.rand(N, generator=g) < 0.1, -1e30, 0.0)
    return [t.cuda() for t in (q, packed, scales, pen)]


def attention_bwd_float64(torch, qkv, dout, heads):
    B, T, W3 = qkv.shape
    W = W3 // 3
    D = W // heads
    q, k, v = (t.double().view(B, T, heads, D).transpose(1, 2)
               for t in qkv.split(W, dim=-1))
    g = dout.double().view(B, T, heads, D).transpose(1, 2)
    p = (q @ k.transpose(-1, -2) * D ** -0.5).softmax(-1)
    dp = g @ v.transpose(-1, -2)
    dl = p * (dp - (dp * p).sum(-1, keepdim=True))
    parts = (dl @ k * D ** -0.5, dl.transpose(-1, -2) @ q * D ** -0.5,
             p.transpose(-1, -2) @ g)
    return torch.cat([t.transpose(1, 2).reshape(B, T, W) for t in parts],
                     dim=-1)


def ptxas() -> None:
    """Registers, spills and shared memory of every kernel of the B1/B5 and
    B3 sources, from ``nvcc -Xptxas -v``."""
    import re
    import tempfile

    for f in ("clip_attention", "int4_scan"):
        with tempfile.TemporaryDirectory() as tmp:
            log = subprocess.run(
                [*NVCC, "-Xptxas", "-v", "-I", str(HERE), "-o",
                 f"{tmp}/{f}.so", str(HERE / f"{f}.cu")],
                capture_output=True, text=True, check=True).stderr
        name = None
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                name = entry.group(1)
            elif name and ("Used" in line or "spill" in line):
                print(f, name, line.split(":", 1)[-1].strip(), flush=True)


SOURCE_OF = {"b1": "clip_attention", "b5": "clip_attention",
             "b3": "int4_scan", "b4": "medoid"}


def build_variants(out_dir: Path, only: str | None) -> None:
    """One nvcc per variant and source, all started together; with ``only``
    just that kernel's source."""
    procs = []
    for name, (header_edits, source_edits) in VARIANTS.items():
        src = out_dir / name
        src.mkdir(parents=True, exist_ok=True)
        texts = {"mma.cuh": (HERE / "mma.cuh").read_text()}
        for old, new in header_edits:
            assert old in texts["mma.cuh"], (name, old)
            texts["mma.cuh"] = texts["mma.cuh"].replace(old, new)
        # A source is built where the variant differs from the committed
        # one: an edit matched it, or the header changed under it.
        build = []
        for f in SOURCES:
            text = (HERE / f"{f}.cu").read_text()
            texts[f + ".cu"] = text
            for old, new in source_edits:
                texts[f + ".cu"] = texts[f + ".cu"].replace(old, new)
            if name == "committed" or texts[f + ".cu"] != text or \
                    (header_edits and f != "int4_scan"):
                build.append(f)
        assert build, (name, "no edit matched any source")
        if only:
            build = [f for f in build if f == SOURCE_OF[only]]
        for f, text in texts.items():
            (src / f).write_text(text)
        for f in build:
            procs.append((name, f, subprocess.Popen(
                [*NVCC, "-I", str(src), "-o", str(src / f"{f}.so"),
                 str(src / f"{f}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, f, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{f}:\n{log}")


PTR, I32 = ctypes.c_void_p, ctypes.c_int
VARIANT_DIR = ROOT / "build" / "variants"


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream


def attention(torch, name):
    lib = ctypes.CDLL(str(VARIANT_DIR / name / "clip_attention.so"))
    lib.clip_attention_fwd.argtypes = [PTR, PTR, I32, I32, I32, I32,
                                       ctypes.c_float, I32, PTR]

    def run(qkv, heads):
        B, T, W3 = qkv.shape
        D = W3 // 3 // heads
        out = torch.empty(B, T, W3 // 3, dtype=qkv.dtype, device="cuda")
        rc = lib.clip_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), B, T, heads, D, D ** -0.5,
            int(qkv.dtype == torch.bfloat16), _stream(torch))
        assert rc == 0, rc
        return out
    return run


def attention_bwd(torch, name):
    lib = ctypes.CDLL(str(VARIANT_DIR / name / "clip_attention.so"))
    lib.clip_attention_bwd.argtypes = [PTR, PTR, PTR, I32, I32, I32, I32,
                                       ctypes.c_float, I32, PTR]

    def run(qkv, dout, heads):
        B, T, W3 = qkv.shape
        D = W3 // 3 // heads
        out = torch.empty_like(qkv)
        rc = lib.clip_attention_bwd(
            qkv.data_ptr(), dout.data_ptr(), out.data_ptr(), B, T, heads, D,
            D ** -0.5, int(qkv.dtype == torch.bfloat16), _stream(torch))
        assert rc == 0, rc
        return out
    return run


def int4(torch, name):
    lib = ctypes.CDLL(str(VARIANT_DIR / name / "int4_scan.so"))
    lib.int4_scan.argtypes = [PTR, PTR, PTR, PTR, PTR, I32, I32, I32, PTR]

    def run(q, packed, scales, pen):
        out = torch.empty(q.shape[0], packed.shape[0], device="cuda")
        rc = lib.int4_scan(q.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                           pen.data_ptr(), out.data_ptr(), q.shape[0],
                           packed.shape[0], q.shape[1], _stream(torch))
        assert rc == 0, rc
        return out
    return run


def medoid(torch, name):
    lib = ctypes.CDLL(str(VARIANT_DIR / name / "medoid.so"))
    lib.medoid_sums.argtypes = [PTR, PTR, PTR, PTR, I32, I32, I32, PTR]

    def run(x):
        n, d = x.shape
        slots = -(-n // 128)
        sq, out = (torch.empty(n, device="cuda") for _ in range(2))
        partial = torch.empty(slots, n, device="cuda")
        rc = lib.medoid_sums(x.data_ptr(), sq.data_ptr(), partial.data_ptr(),
                             out.data_ptr(), n, d, slots, _stream(torch))
        assert rc == 0, rc
        return out
    return run


def variants_b1(torch, CA):
    """B1 in f32 against float64, at unit and x30 logits, then its time."""
    for gain in (1.0, 30.0):
        for B, T, H, D in ((4, 50, 12, 64), (2, 77, 4, 64), (64, 50, 12, 64)):
            g = torch.Generator().manual_seed(T + D)
            qkv = torch.randn(B, T, 3 * H * D, generator=g)
            qkv[..., :H * D] *= gain
            qkv = qkv.cuda()
            ref = attention_float64(qkv, H)
            plain = CA.clip_attention_core_plain(qkv, H)
            row = {"gain": gain, "shape": [B, T, H, D],
                   "plain": float((plain.double() - ref).abs().max())}
            for name in ("committed", "chain"):
                got = attention(torch, name)(qkv, H)
                row[name] = float((got.double() - ref).abs().max())
            print("b1_f32_err_vs_float64", json.dumps(row), flush=True)
    qkv = torch.randn(64, 50, 2304, device="cuda")
    qkv16 = qkv.bfloat16()
    for name in ("committed", "chain", "nosplit", "onemma"):
        fn = attention(torch, name)
        print("b1_ms", name, json.dumps({
            "f32": graph_ms(torch, lambda: fn(qkv, 12)),
            "bf16": graph_ms(torch, lambda: fn(qkv16, 12))}), flush=True)


def variants_b5(torch, CA):
    """B5 against float64 at unit and x30 logits, then its time."""
    names = ("committed", "chain", "once", "bwd1", "bwd4")
    for dtype in (torch.float32, torch.bfloat16):
        for gain in (1.0, 30.0):
            g = torch.Generator().manual_seed(11)
            x = torch.randn(64, 50, 2304, generator=g)
            x[..., :768] *= gain
            x = x.cuda().to(dtype)
            dout = torch.randn(64, 50, 768, generator=g).cuda().to(dtype)
            ref = attention_bwd_float64(torch, x, dout, 12)
            plain = CA.clip_attention_core_bwd_plain(x, dout, 12)
            row = {"dtype": str(dtype), "gain": gain,
                   "plain": float((plain.double() - ref).abs().max())}
            for name in names[:3]:
                got = attention_bwd(torch, name)(x, dout, 12)
                row[name] = float((got.double() - ref).abs().max())
            print("b5_err_vs_float64", json.dumps(row), flush=True)
    qkv = torch.randn(64, 50, 2304, device="cuda")
    dout = torch.randn(64, 50, 768, device="cuda")
    qkv16, dout16 = qkv.bfloat16(), dout.bfloat16()
    for _ in range(2):
        for name in names:
            fn = attention_bwd(torch, name)
            print("b5_ms", name, json.dumps({
                "f32": graph_ms(torch, lambda: fn(qkv, dout, 12)),
                "bf16": graph_ms(torch, lambda: fn(qkv16, dout16, 12))}),
                flush=True)


def variants_b3(torch, S4):
    """B3: equal to the plain scan, then its time."""
    args = int4_case(torch)
    want = S4.int4_scan_scores_plain(*args)
    for _ in range(2):
        for name in ("committed", "sm2", "sm3", "sm6", "sm8"):
            fn = int4(torch, name)
            print("b3_ms", name, json.dumps({
                "equals_plain": bool(torch.equal(fn(*args), want)),
                "ms": events_ms(torch, lambda: fn(*args), reps=20)}),
                flush=True)


def variants_b4(torch, M):
    """B4 on near-duplicate rows against float64, then its time."""
    for n in (600, 3_000, 12_000):
        x, ref = near_duplicates(torch, n, seed=n)
        plain = M.pairwise_distance_sums_plain(x)
        row = {"n": n, "tol": 5e-2 + 1e-4 * float(ref.min()),
               "plain": float((plain.double() - ref).abs().max())}
        for name in ("committed", "chain", "bounds1"):
            got = medoid(torch, name)(x)
            row[name] = float((got.double() - ref).abs().max())
        print("b4_near_duplicates_err_vs_float64", json.dumps(row),
              flush=True)
    x = unit_rows(torch)
    for _ in range(2):
        for name in ("committed", "chain", "nosplit", "onemma", "bounds1"):
            fn = medoid(torch, name)
            print("b4_ms", name, events_ms(torch, lambda: fn(x)), flush=True)


def run_variants(only: str | None = None) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    from retrieval_based_object_detection_tpu_torch.ops import (
        clip_attention as CA, int4_scan as S4, medoid as M,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    build_variants(VARIANT_DIR, only)
    print(card(), flush=True)
    sections = {"b1": (variants_b1, CA), "b5": (variants_b5, CA),
                "b3": (variants_b3, S4), "b4": (variants_b4, M)}
    for key in [only] if only else sections:
        fn, module = sections[key]
        fn(torch, module)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("command", choices=("time", "variants", "ptxas"))
    parser.add_argument("--root", type=Path, default=ROOT)
    parser.add_argument("--only", choices=sorted(SOURCE_OF),
                        help="variants: just this kernel's")
    args = parser.parse_args(argv)
    if args.command == "time":
        print(json.dumps(time_checkout(args.root.resolve())), flush=True)
    elif args.command == "ptxas":
        ptxas()
    else:
        run_variants(args.only)
    return 0


if __name__ == "__main__":
    sys.exit(main())
