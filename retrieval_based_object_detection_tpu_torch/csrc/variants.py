#!/usr/bin/env python3
"""Time and check the tensor-core kernels B1 and B4, and variants of them, on
one NVIDIA GPU.

    python3 retrieval_based_object_detection_tpu_torch/csrc/variants.py time [--root DIR]
    python3 retrieval_based_object_detection_tpu_torch/csrc/variants.py variants

``time`` prints one JSON line for the checkout at ``--root`` (default: the
one this file lies in): B1 at [64, 50, 2304] in bf16 and f32 (device time
from a CUDA graph's replay, and events around eager calls) beside
``scaled_dot_product_attention``, and B4 at 12,000 x 512 beside
``torch.cdist(x, x).sum(1)``. To compare two commits on one card, unpack
the other one somewhere and run ``time`` for each root in turns, one
right after the other.

``variants`` builds copies of ``clip_attention.cu`` and ``medoid.cu`` with
one thing changed each (string edits of the sources, built into
``build/variants/``), and prints for each its distance from a float64
reference and its time beside the committed kernels':

- ``chain``: the running sums left in the tensor core's accumulator
  (``mma_3xtf32`` where the sources call ``mma_3xtf32_rn``);
- ``nosplit``: no hi/lo split (wrong results; what a free split would gain);
- ``onemma``: one TF32 product of the three, no split (wrong results; what
  the tensor-core work costs);
- ``bounds1``: B4's tile kernel without its two-blocks-an-SM launch bound.

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
}


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
        clip_attention as CA, cuda_lib, medoid as M,
    )
    cuda_lib.build_all([CA.KERNEL, M.KERNEL])
    B, T, H, D = 64, 50, 12, 64
    base = torch.randn(B, T, 3 * H * D,
                       generator=torch.Generator().manual_seed(0)).cuda()
    out = {"root": str(root), "card": card()}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qkv = base.to(dtype)
        q, k, v = (t.view(B, T, H, D).transpose(1, 2)
                   for t in qkv.split(H * D, dim=-1))
        out[f"b1_{name}_ms"] = graph_ms(
            torch, lambda: CA.clip_attention_core(qkv, H))
        out[f"b1_{name}_eager_ms"] = events_ms(
            torch, lambda: CA.clip_attention_core(qkv, H), reps=20)
        out[f"sdpa_{name}_ms"] = graph_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v))
    x = unit_rows(torch)
    out["b4_ms"] = events_ms(torch, lambda: M.pairwise_distance_sums(x))
    out["cdist_ms"] = events_ms(torch, lambda: torch.cdist(x, x).sum(1))
    return out


def build_variants(out_dir: Path) -> None:
    """One nvcc per variant and source, all started together."""
    procs = []
    for name, (header_edits, source_edits) in VARIANTS.items():
        src = out_dir / name
        src.mkdir(parents=True, exist_ok=True)
        texts = {"mma.cuh": (HERE / "mma.cuh").read_text()}
        for old, new in header_edits:
            assert old in texts["mma.cuh"], (name, old)
            texts["mma.cuh"] = texts["mma.cuh"].replace(old, new)
        for f in ("clip_attention.cu", "medoid.cu"):
            texts[f] = (HERE / f).read_text()
            for old, new in source_edits:
                texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            (src / f).write_text(text)
        for f in ("clip_attention", "medoid"):
            procs.append((name, f, subprocess.Popen(
                ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-I", str(src), "-o", str(src / f"{f}.so"),
                 str(src / f"{f}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, f, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{f}:\n{log}")


def run_variants() -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    from retrieval_based_object_detection_tpu_torch.ops import (
        clip_attention as CA, medoid as M,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = ROOT / "build" / "variants"
    build_variants(out_dir)
    print(card(), flush=True)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def attention(name):
        lib = ctypes.CDLL(str(out_dir / name / "clip_attention.so"))
        lib.clip_attention_fwd.argtypes = [ptr, ptr, i32, i32, i32, i32,
                                           ctypes.c_float, i32, ptr]

        def run(qkv, heads):
            B, T, W3 = qkv.shape
            D = W3 // 3 // heads
            out = torch.empty(B, T, W3 // 3, dtype=qkv.dtype, device="cuda")
            rc = lib.clip_attention_fwd(
                qkv.data_ptr(), out.data_ptr(), B, T, heads, D, D ** -0.5,
                int(qkv.dtype == torch.bfloat16), stream())
            assert rc == 0, rc
            return out
        return run

    def medoid(name):
        lib = ctypes.CDLL(str(out_dir / name / "medoid.so"))
        lib.medoid_sums.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, ptr]

        def run(x):
            n, d = x.shape
            slots = -(-n // 128)
            sq, out = (torch.empty(n, device="cuda") for _ in range(2))
            partial = torch.empty(slots, n, device="cuda")
            rc = lib.medoid_sums(x.data_ptr(), sq.data_ptr(),
                                 partial.data_ptr(), out.data_ptr(), n, d,
                                 slots, stream())
            assert rc == 0, rc
            return out
        return run

    # B1 in f32 against float64, at unit and x30 logits.
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
                got = attention(name)(qkv, H)
                row[name] = float((got.double() - ref).abs().max())
            print("b1_f32_err_vs_float64", json.dumps(row), flush=True)
    qkv = torch.randn(64, 50, 2304, device="cuda")
    qkv16 = qkv.bfloat16()
    for name in VARIANTS:
        fn = attention(name)
        print("b1_ms", name, json.dumps({
            "f32": graph_ms(torch, lambda: fn(qkv, 12)),
            "bf16": graph_ms(torch, lambda: fn(qkv16, 12))}), flush=True)

    # B4 on near-duplicate rows against float64, then its time.
    for n in (600, 3_000, 12_000):
        x, ref = near_duplicates(torch, n, seed=n)
        plain = M.pairwise_distance_sums_plain(x)
        row = {"n": n, "tol": 5e-2 + 1e-4 * float(ref.min()),
               "plain": float((plain.double() - ref).abs().max())}
        for name in ("committed", "chain", "bounds1"):
            got = medoid(name)(x)
            row[name] = float((got.double() - ref).abs().max())
        print("b4_near_duplicates_err_vs_float64", json.dumps(row),
              flush=True)
    x = unit_rows(torch)
    for _ in range(2):
        for name in VARIANTS:
            fn = medoid(name)
            print("b4_ms", name, events_ms(torch, lambda: fn(x)), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("command", choices=("time", "variants"))
    parser.add_argument("--root", type=Path, default=ROOT)
    args = parser.parse_args(argv)
    if args.command == "time":
        print(json.dumps(time_checkout(args.root.resolve())), flush=True)
    else:
        run_variants()
    return 0


if __name__ == "__main__":
    sys.exit(main())
