"""The tensor-core kernels' arithmetic and index maps, emulated on the CPU.

The CUDA kernels in ``retrieval_based_object_detection_tpu_torch/csrc/`` run
only on a GPU. What can be held to account without one is emulated here in
numpy/torch, against the port's plain versions:

- the 3xTF32 split on float32 bit patterns (``split_tf32`` of ``mma.cuh``)
  and what it buys the blocked medoid (B4) on near-duplicate rows, where one
  TF32 product is not enough;
- B4's symmetric tile schedule: every ``(slot, row)`` of the scratch written
  exactly once, super-blocks included, and the summed slots equal to
  ``pairwise_distance_sums_plain``;
- the fragment layouts of ``mma.sync`` (m16n8k8 for TF32, m16n8k16 for bf16)
  and ``ldmatrix`` as the PTX ISA defines them, lane by lane, driven by the
  very index expressions ``medoid.cu`` and ``clip_attention.cu`` use;
- the attention core's (B1) order of operations: p normalised, rounded to
  the input type, then multiplied into V, in one key tile and in the
  two-pass form;
- the attention core's backward (B5) in both orientations: fragment loads,
  accumulators reused as A fragments, the stored m, l and delta, the bf16
  hi/lo split, dq from registers and dk, dv through the warp's own rows,
  against the plain backward and the JAX package's Pallas kernel in
  interpret mode;
- ``mma.sync.m16n8k32.s8`` and the int4 scan's (B3) load, biased unpack,
  fragment map and bias correction, bit for bit against the plain scan and
  the JAX twin;
- the int8 scan's (B2) loads, k order, fragments, masks of the ragged group
  and of dims past the last whole chunk, and passes over the queries, bit
  for bit against the plain scan and the JAX package's Pallas kernel in
  interpret mode.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu.ops.clip_attention import (
    _pallas_attn_bwd,
)
from retrieval_based_object_detection_tpu.ops.int4_scan import (
    int4_scan_scores as jax_int4_scan,
)
from retrieval_based_object_detection_tpu.ops.int8_scan import (
    int8_scan_scores as jax_int8_scan,
)
from retrieval_based_object_detection_tpu_torch.ops import clip_attention as CA
from retrieval_based_object_detection_tpu_torch.ops import int4_scan as S4
from retrieval_based_object_detection_tpu_torch.ops import int8_scan as S8
from retrieval_based_object_detection_tpu_torch.ops import medoid as M

LANES = np.arange(32)
GQ, TQ = LANES >> 2, LANES & 3  # fragment row and column group of a lane


# ---------------------------------------------------------------- 3xTF32 --

def split_tf32(x):
    """``split_tf32`` of mma.cuh on float32 arrays: hi is x rounded to tf32
    by half an ulp added and 13 bits cleared, lo = x - hi in f32."""
    bits = x.astype(np.float32).view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)
    return hi, (x.astype(np.float32) - hi).astype(np.float32)


def tf32_trunc(x):
    """What the tensor core reads of an f32 operand: the low 13 mantissa
    bits ignored."""
    return (x.astype(np.float32).view(np.uint32)
            & np.uint32(0xffffe000)).view(np.float32)


def gram_3xtf32(x):
    """x xᵀ as the kernel forms it: lo·hi + hi·lo + hi·hi, each product of
    tf32 operands exact, the three added in f32."""
    hi, lo = split_tf32(x)
    lo = tf32_trunc(lo).astype(np.float64)
    hi = hi.astype(np.float64)
    small = (lo @ hi.T).astype(np.float32) + (hi @ lo.T).astype(np.float32)
    return small + (hi @ hi.T).astype(np.float32)


def gram_1xtf32(x):
    t = tf32_trunc(x).astype(np.float64)
    return (t @ t.T).astype(np.float32)


def sums_from_gram(x, gram):
    """The epilogue of medoid.cu on a whole Gram matrix, in f32."""
    sq = np.sum(x * x, axis=1, dtype=np.float32)
    d2 = (sq[:, None] + sq[None, :]) - np.float32(2.0) * gram
    np.fill_diagonal(d2, 0.0)
    return np.sqrt(np.maximum(d2, np.float32(0.0))).sum(axis=1,
                                                        dtype=np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 37.5, 1e20])
def test_split_tf32_is_exact(scale):
    x = (np.random.default_rng(0).normal(size=4096) * scale
         ).astype(np.float32)
    hi, lo = split_tf32(x)
    assert np.array_equal(hi + lo, x)
    # hi is a tf32 value, and lo is at most half a tf32 ulp of x.
    assert np.array_equal(tf32_trunc(hi), hi)
    assert np.all(np.abs(lo) <= np.abs(x) * 2.0 ** -11)


def _near_duplicates(n, d, seed):
    rng = np.random.default_rng(seed)
    centre = rng.normal(size=d)
    centre /= np.linalg.norm(centre)
    return (centre + 1e-3 * rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("n,seed", [(600, 1), (1500, 2)])
def test_3xtf32_gram_keeps_f32_accuracy_on_near_duplicates(n, seed):
    """A class of jittered crops: one unit centre plus 1e-3 noise, 512-d.
    d² is a difference of nearly equal numbers, so the Gram matrix must be
    f32-accurate. The three-product split is as close to float64 direct
    distances as the plain f32 version; one TF32 product is far outside the
    medoid's tolerance and picks another member."""
    x = _near_duplicates(n, 512, seed)
    x64 = x.astype(np.float64)
    ref = np.sqrt(((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)).sum(1) \
        if n <= 600 else np.sqrt(np.maximum(
            (x64 ** 2).sum(1)[:, None] + (x64 ** 2).sum(1)[None, :]
            - 2 * x64 @ x64.T, 0) * (1 - np.eye(n))).sum(1)
    plain = M.pairwise_distance_sums_plain(torch.from_numpy(x)).numpy()
    three = sums_from_gram(x, gram_3xtf32(x))
    one = sums_from_gram(x, gram_1xtf32(x))
    err_plain = np.abs(plain - ref).max()
    err_three = np.abs(three - ref).max()
    err_one = np.abs(one - ref).max()
    tol = 5e-2 + 1e-4 * ref.min()  # the medoid tolerance (atol, rtol)
    assert err_three <= 2 * err_plain + 1e-4 * ref.min()
    assert err_three <= tol
    best = ref.min()
    assert ref[np.argmin(three)] - best <= ref[np.argmin(plain)] - best + 1e-3
    assert err_one > tol and err_one > 20 * err_three
    assert np.argmin(one) != np.argmin(ref)


def _toward_zero_f32(x64):
    """float64 -> float32 by truncation: what the tensor core's accumulator
    keeps of a sum (it does not round to nearest)."""
    y = x64.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x64)
    return np.where(over, np.nextafter(y, np.float32(0.0)), y)


def gram_3xtf32_by_k8_steps(x, sum_outside):
    """x xᵀ step by step as the hardware forms it: every mma adds its eight
    exact products to its accumulator and truncates. ``sum_outside=False``
    chains all mma on one accumulator (``mma_3xtf32`` of mma.cuh);
    ``sum_outside=True`` starts each k8 step's three products from zero and
    adds their sum to the running f32 sum by a round-to-nearest add
    (``mma_3xtf32_rn``, what medoid.cu and clip_attention.cu use)."""
    hi, lo = split_tf32(x)
    lo = tf32_trunc(lo)
    acc = np.zeros((x.shape[0], x.shape[0]), np.float32)
    for k0 in range(0, x.shape[1], 8):
        h = hi[:, k0:k0 + 8].astype(np.float64)
        l = lo[:, k0:k0 + 8].astype(np.float64)
        t = np.zeros_like(acc) if sum_outside else acc
        for a, b in ((l, h), (h, l), (h, h)):
            t = _toward_zero_f32(t.astype(np.float64) + a @ b.T)
        acc = acc + t if sum_outside else t
    return acc


def test_tensor_core_accumulator_truncation_needs_the_sum_outside():
    """Measured on the H100: with the running sum left in the tensor core
    the distance sums of 600 near-duplicate rows were 0.099 off float64
    (tolerance 0.052), with the sum kept outside 0.0018 (the plain version:
    0.0016). The truncating accumulator explains it: this emulation gives
    0.073 and 0.0024."""
    x = _near_duplicates(600, 512, 1)
    x64 = x.astype(np.float64)
    ref = np.sqrt(((x64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)).sum(1)
    plain = M.pairwise_distance_sums_plain(torch.from_numpy(x)).numpy()
    tol = 5e-2 + 1e-4 * ref.min()
    err_chain = np.abs(sums_from_gram(
        x, gram_3xtf32_by_k8_steps(x, sum_outside=False)) - ref).max()
    err_outside = np.abs(sums_from_gram(
        x, gram_3xtf32_by_k8_steps(x, sum_outside=True)) - ref).max()
    err_plain = np.abs(plain - ref).max()
    assert err_chain > tol
    assert err_outside <= 0.1 * tol
    assert err_outside <= 2 * err_plain + 1e-4 * ref.min()


def test_3xtf32_gram_matches_f32_on_unit_rows():
    x = np.random.default_rng(3).normal(size=(300, 512)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    exact = x.astype(np.float64) @ x.astype(np.float64).T
    assert np.abs(gram_3xtf32(x) - exact).max() < 2e-6
    assert np.abs(gram_1xtf32(x) - exact).max() > 1e-4


# ------------------------------------------------- B4: symmetric schedule --

TILE = M._TILE


def _triangular_decode(p):
    """medoid.cu's pair numbering inside one super-block, float sqrt and
    integer correction as in the kernel."""
    bb = int((np.sqrt(np.float32(8.0) * np.float32(p) + np.float32(1.0))
              - np.float32(1.0)) * np.float32(0.5))
    while bb * (bb + 1) // 2 > p:
        bb -= 1
    while (bb + 1) * (bb + 2) // 2 <= p:
        bb += 1
    return p - bb * (bb + 1) // 2, bb


def emulate_medoid_schedule(x, slots):
    """``medoid_sums`` of medoid.cu at tile level in torch: super-blocks of
    ``slots`` row tiles, pairs a <= b, row sums to partial[b - j0][rows of
    a], column sums to partial[a - i0][rows of b], then the slots added in
    order. Returns the sums and the largest number of writes any used slot
    received (1) and the smallest (1)."""
    n = x.shape[0]
    sq = (x * x).sum(1)
    tiles = -(-n // TILE)
    sums = torch.zeros(n)
    most, least = 0, 10
    for i0 in range(0, tiles, slots):
        ti = min(slots, tiles - i0)
        for j0 in range(i0, tiles, slots):
            tj = min(slots, tiles - j0)
            partial = torch.full((slots, n), float("nan"))
            writes = torch.zeros((slots, n), dtype=torch.int32)
            pairs = ti * (ti + 1) // 2 if i0 == j0 else ti * tj
            for p in range(pairs):
                if i0 == j0:
                    a, b = _triangular_decode(p)
                    a, b = a + i0, b + i0
                else:
                    a, b = i0 + p % ti, j0 + p // ti
                assert a <= b
                r = slice(a * TILE, min(n, (a + 1) * TILE))
                c = slice(b * TILE, min(n, (b + 1) * TILE))
                d2 = sq[r, None] + sq[None, c] - 2.0 * (x[r] @ x[c].T)
                if a == b:
                    d2.fill_diagonal_(0.0)
                dist = torch.sqrt(torch.clamp(d2, min=0.0))
                partial[b - j0, r] = dist.sum(1)
                writes[b - j0, r] += 1
                if a != b:
                    partial[a - i0, c] = dist.sum(0)
                    writes[a - i0, c] += 1

            def add(tile0, count, used):
                nonlocal most, least
                rows = slice(tile0 * TILE, min(n, (tile0 + count) * TILE))
                most = max(most, int(writes[:used, rows].max()))
                least = min(least, int(writes[:used, rows].min()))
                writes[:used, rows] = 0
                s = torch.zeros(rows.stop - rows.start)
                for g in range(used):
                    s = s + partial[g, rows]
                sums[rows] += s

            add(i0, ti, tj)
            if i0 != j0:
                add(j0, tj, ti)
            assert int(writes.sum()) == 0  # nothing written outside the adds
    return sums, most, least


@pytest.mark.parametrize("n", [1, 65, 130, 1000])
@pytest.mark.parametrize("slots", [None, 1, 3])
def test_symmetric_schedule_writes_each_slot_once(n, slots):
    """Ragged N, one super-block (slots = tiles) and several: each used
    (slot, row) is written exactly once, and the sums are the plain ones to
    the medoid tolerance."""
    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, 36)).astype(np.float32))
    tiles = -(-n // TILE)
    sums, most, least = emulate_medoid_schedule(
        x, tiles if slots is None else min(slots, tiles))
    assert (most, least) == (1, 1)
    assert torch.isfinite(sums).all()
    torch.testing.assert_close(sums, M.pairwise_distance_sums_plain(x),
                               rtol=1e-4, atol=5e-2)


def test_triangular_decode_covers_the_upper_triangle():
    for tiles in (1, 2, 7, 94, 363):
        got = [_triangular_decode(p) for p in range(tiles * (tiles + 1) // 2)]
        assert got == [(a, b) for b in range(tiles) for a in range(b + 1)]
    # Far past what float32 holds exactly, the integer correction decides.
    for p in (2 ** 24 + 1, 2 ** 30 + 12345):
        a, b = _triangular_decode(p)
        assert 0 <= a <= b and b * (b + 1) // 2 + a == p


def test_scratch_slots_follow_the_byte_budget():
    """The wrapper's slot count: one per tile while the scratch fits its
    budget, fewer (super-blocks) past it, never zero."""
    def slots(n):
        return min(-(-n // TILE), max(1, M._SCRATCH_BYTES // (4 * n)))

    assert slots(12_000) == 94
    assert slots(100_000) * 100_000 * 4 <= M._SCRATCH_BYTES
    assert slots(100_000) < -(-100_000 // TILE)
    assert slots(2 ** 30) == 1


# ----------------------------------- mma.sync / ldmatrix, lane by lane --

def mma_m16n8k8(a, b):
    """PTX mma.m16n8k8 (tf32): a [32, 4], b [32, 2] per-lane registers →
    c [32, 4]. A(16x8): a0 (gq, tq), a1 (gq+8, tq), a2 (gq, tq+4),
    a3 (gq+8, tq+4). B(8x8): b0 (k tq, n gq), b1 (k tq+4, n gq).
    C(16x8): c0 (gq, 2tq), c1 (gq, 2tq+1), c2 (gq+8, 2tq), c3 (gq+8, 2tq+1).
    """
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    A[GQ, TQ], A[GQ + 8, TQ] = a[:, 0], a[:, 1]
    A[GQ, TQ + 4], A[GQ + 8, TQ + 4] = a[:, 2], a[:, 3]
    B[TQ, GQ], B[TQ + 4, GQ] = b[:, 0], b[:, 1]
    C = A @ B
    return np.stack([C[GQ, 2 * TQ], C[GQ, 2 * TQ + 1],
                     C[GQ + 8, 2 * TQ], C[GQ + 8, 2 * TQ + 1]], axis=1)


def mma_m16n8k16(a, b):
    """PTX mma.m16n8k16 (bf16): a [32, 4, 2], b [32, 2, 2] (pairs packed in
    one register) → c [32, 4]. A(16x16): a0 (gq, 2tq..+1), a1 (gq+8, ..),
    a2 (gq, 2tq+8..), a3 (gq+8, 2tq+8..). B(16x8): b0 (k 2tq..+1, n gq),
    b1 (k 2tq+8.., n gq)."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for j in range(2):
        A[GQ, 2 * TQ + j], A[GQ + 8, 2 * TQ + j] = a[:, 0, j], a[:, 1, j]
        A[GQ, 2 * TQ + 8 + j] = a[:, 2, j]
        A[GQ + 8, 2 * TQ + 8 + j] = a[:, 3, j]
        B[2 * TQ + j, GQ], B[2 * TQ + 8 + j, GQ] = b[:, 0, j], b[:, 1, j]
    C = A @ B
    return np.stack([C[GQ, 2 * TQ], C[GQ, 2 * TQ + 1],
                     C[GQ + 8, 2 * TQ], C[GQ + 8, 2 * TQ + 1]], axis=1)


def ldmatrix_x4(smem, rows, cols, trans=False):
    """PTX ldmatrix.x4 (b16): lane l supplies the address (rows[l], cols[l])
    of an 8-element row; lanes 8i..8i+7 address matrix i. Returns [32, 4, 2]:
    lane l holds of each matrix the elements (l/4, 2(l%4)..+1), or with
    .trans (2(l%4)..+1, l/4)."""
    out = np.zeros((32, 4, 2))
    for i in range(4):
        mat = np.stack([smem[rows[8 * i + r], cols[8 * i + r]:
                             cols[8 * i + r] + 8] for r in range(8)])
        if trans:
            mat = mat.T
        out[:, i, 0] = mat[GQ, 2 * TQ]
        out[:, i, 1] = mat[GQ, 2 * TQ + 1]
    return out


@pytest.mark.parametrize("dim", [32, 36, 72])
def test_medoid_tile_fragments_give_the_gram_tile(dim):
    """medoid.cu's fragment loads (8-byte pairs at column 2tq of a padded
    panel row, dims 2tq and 2tq+1 in the k8 chunk's columns tq and tq+4)
    and its accumulator-to-(row, column) map, through the PTX layouts: the
    128 x 128 tile is A Bᵀ, the zero-filled panel tail included."""
    rng = np.random.default_rng(dim)
    depth, ld = 32, 40
    A = rng.normal(size=(128, dim))
    B = rng.normal(size=(128, dim))
    out = np.zeros((128, 128))
    for kp in range(-(-dim // depth)):
        pa = np.full((128, ld), np.nan)
        pb = np.full((128, ld), np.nan)
        w = min(depth, dim - kp * depth)
        pa[:, :depth], pb[:, :depth] = 0.0, 0.0  # cp.async zero fill
        pa[:, :w] = A[:, kp * depth: kp * depth + w]
        pb[:, :w] = B[:, kp * depth: kp * depth + w]
        for warp in range(8):
            wrow, wcol = (warp >> 2) * 64, (warp & 3) * 32
            for k8 in range(depth // 8):
                for mi in range(4):
                    r = wrow + mi * 16 + GQ
                    c = k8 * 8 + 2 * TQ
                    a = np.stack([pa[r, c], pa[r + 8, c], pa[r, c + 1],
                                  pa[r + 8, c + 1]], axis=1)
                    for ni in range(4):
                        bc = wcol + ni * 8 + GQ
                        b = np.stack([pb[bc, c], pb[bc, c + 1]], axis=1)
                        acc = mma_m16n8k8(a, b)
                        for e in range(4):
                            lr = wrow + mi * 16 + GQ + (e >> 1) * 8
                            lc = wcol + ni * 8 + 2 * TQ + (e & 1)
                            out[lr, lc] += acc[:, e]
    np.testing.assert_allclose(out, A @ B.T, atol=1e-10)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float(
    ).numpy()


def emulate_attention_block(q, k, v, dtype):
    """One (image, head) of clip_attention.cu's forward, lane by lane: q, k,
    v [T, D] already in the input type's values. Shared-memory rows are
    NaN where the kernel never writes and zero where cp.async zero-fills."""
    T, D = q.shape
    bf16 = dtype == torch.bfloat16
    kD = 32 if D <= 32 else 64 if D <= 64 else 128
    ldk, ldv = kD + 8, kD + (8 if bf16 else 4)
    ntiles = -(-T // 64)
    rows = ntiles * 64
    qs, ks = np.full((rows, ldk), np.nan), np.full((rows, ldk), np.nan)
    vs = np.full((rows, ldv), np.nan)
    for buf, src in ((qs, q), (ks, k), (vs, v)):
        buf[:, :kD] = 0.0
        buf[:T, :D] = src
    nk16, nd8 = -(-D // 16), D // 8
    c2 = np.float32(D ** -0.5) * np.float32(1.4426950408889634)
    mi = LANES >> 3
    out = np.full((T, D), np.nan)

    def logits(r0, t):
        s = np.zeros((8, 32, 4), np.float32)
        kt = ks[t * 64:]
        if bf16:
            arow = r0 + (LANES & 7) + np.where(mi & 1, 8, 0)
            acol = np.where(mi & 2, 8, 0)
            krow = (LANES & 7) + np.where(mi & 2, 8, 0)
            kcol = np.where(mi & 1, 8, 0)
            for kc in range(nk16):
                a = ldmatrix_x4(qs, arow, kc * 16 + acol)
                for np_ in range(4):
                    kb = ldmatrix_x4(kt, np_ * 16 + krow, kc * 16 + kcol)
                    s[2 * np_] += mma_m16n8k16(a, kb[:, 0:2])
                    s[2 * np_ + 1] += mma_m16n8k16(a, kb[:, 2:4])
        else:
            for kc in range(nd8):
                c = kc * 8 + 2 * TQ
                a = np.stack([qs[r0 + GQ, c], qs[r0 + GQ + 8, c],
                              qs[r0 + GQ, c + 1], qs[r0 + GQ + 8, c + 1]],
                             axis=1)
                for n in range(8):
                    b = np.stack([kt[n * 8 + GQ, c], kt[n * 8 + GQ, c + 1]],
                                 axis=1)
                    s[n] += mma_m16n8k8(a, b)
        for n in range(8):
            for j in range(2):
                past = t * 64 + n * 8 + 2 * TQ + j >= T
                s[n][past, j] = -np.inf
                s[n][past, 2 + j] = -np.inf
        return s

    def quad(x, op):  # the two xor shuffles over lanes that share a row
        x = op(x, x[LANES ^ 1])
        return op(x, x[LANES ^ 2])

    for mt in range(-(-T // 16)):
        r0 = mt * 16
        m = np.full((2, 32), -1e30, np.float32)
        l = np.zeros((2, 32), np.float32)
        with np.errstate(over="ignore"):
            for t in range(ntiles):
                s = logits(r0, t)
                for h in range(2):
                    mx = quad(s[:, :, 2 * h: 2 * h + 2].max(axis=(0, 2)),
                              np.maximum)
                    m_new = np.maximum(m[h], mx)
                    l[h] *= np.exp2((m[h] - m_new) * c2)
                    m[h] = m_new
                for n in range(8):
                    for e in range(4):
                        l[e >> 1] += np.exp2((s[n][:, e] - m[e >> 1]) * c2)
        l = np.stack([quad(l[0], np.add), quad(l[1], np.add)])
        o = np.zeros((kD // 8, 32, 4), np.float32)
        for t in range(ntiles):
            if ntiles > 1:
                s = logits(r0, t)
            p = np.zeros_like(s)
            for e in range(4):
                p[:, :, e] = np.exp2((s[:, :, e] - m[e >> 1]) * c2) / l[e >> 1]
            vt = vs[t * 64:]
            if bf16:
                p = _bf16(p)
                vrow = (LANES & 7) + np.where(mi & 1, 8, 0)
                vcol = np.where(mi & 2, 8, 0)
                for kc in range(4):
                    a = np.stack([p[2 * kc][:, 0:2], p[2 * kc][:, 2:4],
                                  p[2 * kc + 1][:, 0:2],
                                  p[2 * kc + 1][:, 2:4]], axis=1)
                    for dp in range(nk16):
                        vb = ldmatrix_x4(vt, kc * 16 + vrow, dp * 16 + vcol,
                                         trans=True)
                        o[2 * dp] += mma_m16n8k16(a, vb[:, 0:2])
                        o[2 * dp + 1] += mma_m16n8k16(a, vb[:, 2:4])
            else:
                for n in range(8):
                    a = np.stack([p[n][:, 0], p[n][:, 2], p[n][:, 1],
                                  p[n][:, 3]], axis=1)
                    vr = n * 8 + 2 * TQ
                    for dp in range(nk16):
                        c = 2 * GQ + 16 * dp
                        o[2 * dp] += mma_m16n8k8(a, np.stack(
                            [vt[vr, c], vt[vr + 1, c]], axis=1))
                        o[2 * dp + 1] += mma_m16n8k8(a, np.stack(
                            [vt[vr, c + 1], vt[vr + 1, c + 1]], axis=1))
        # Staging through the warp's Q rows, then the row copies.
        if bf16:
            for dt in range(nd8):
                c = dt * 8 + 2 * TQ
                for j in range(2):
                    qs[r0 + GQ, c + j] = _bf16(o[dt][:, j])
                    qs[r0 + GQ + 8, c + j] = _bf16(o[dt][:, 2 + j])
        else:
            for dp in range(nk16):
                c = dp * 16 + 4 * TQ
                for half in range(2):
                    row = r0 + GQ + 8 * half
                    qs[row, c] = o[2 * dp][:, 2 * half]
                    qs[row, c + 1] = o[2 * dp + 1][:, 2 * half]
                    qs[row, c + 2] = o[2 * dp][:, 2 * half + 1]
                    qs[row, c + 3] = o[2 * dp + 1][:, 2 * half + 1]
        for r in range(16):
            if r0 + r < T:
                out[r0 + r] = qs[r0 + r, :D]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,D", [(50, 64), (77, 64), (17, 32), (64, 8),
                                 (65, 128), (16, 24)])
def test_attention_fragments_match_plain(dtype, T, D):
    """The forward's index maps through the PTX layouts, in one key tile
    (T <= 64) and in the two-pass form: no NaN from unwritten or padded
    shared memory, and the plain version's values. bf16: p and the output
    round where the plain version's do, up to one bf16 ulp each where the
    f32 sums differ in their last bits."""
    rng = np.random.default_rng(T * D)
    qkv = torch.from_numpy(rng.normal(size=(1, T, 3 * D)).astype(np.float32)
                           ).to(dtype)
    q, k, v = (t[0].float().numpy() for t in qkv.split(D, dim=-1))
    got = emulate_attention_block(q, k, v, dtype)
    want = CA.clip_attention_core_plain(qkv, heads=1)[0].float().numpy()
    assert np.isfinite(got).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=2 ** -7)
        assert np.mean(got == want) > 0.9


# ------------------------------------------- B1: the order of operations --

def attention_in_kernel_order(qkv, heads, tile=64):
    """B1's arithmetic in torch, one (image, head) at a time: raw dots in
    f32, keys in tiles of ``tile``; pass 1 takes the row max and the row sum
    of 2^((s - m) scale log2 e) with the running rescale; pass 2 forms
    p = e / sum, rounds it to the input type and accumulates p v in f32;
    one cast at the end."""
    B, T, W3 = qkv.shape
    W = W3 // 3
    D = W // heads
    c2 = torch.tensor(D ** -0.5, dtype=torch.float32) * 1.4426950408889634
    q, k, v = (t.reshape(B, T, heads, D).transpose(1, 2).float()
               for t in qkv.split(W, dim=-1))
    s = q @ k.transpose(-1, -2)
    m = torch.full((B, heads, T, 1), -1e30)
    l = torch.zeros(B, heads, T, 1)
    for k0 in range(0, T, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.max(-1, keepdim=True).values)
        l = l * torch.exp2((m - m_new) * c2) + \
            torch.exp2((st - m_new) * c2).sum(-1, keepdim=True)
        m = m_new
    out = torch.zeros(B, heads, T, D)
    for k0 in range(0, T, tile):
        p = (torch.exp2((s[..., k0:k0 + tile] - m) * c2) / l).to(qkv.dtype)
        out = out + p.float() @ v[..., k0:k0 + tile, :]
    return out.to(qkv.dtype).transpose(1, 2).reshape(B, T, W)


@pytest.mark.parametrize("B,T,heads,D", [(2, 50, 3, 64), (2, 77, 2, 64),
                                         (1, 130, 2, 32)])
def test_kernel_order_matches_plain_bf16(B, T, heads, D):
    """p normalised, then rounded to bf16, then PV — in one tile (T = 50)
    and in the two-pass form (T = 77, 130): the plain version's bf16 values
    bit for bit wherever the f32 sums round alike, one ulp of p or of the
    output apart elsewhere."""
    rng = np.random.default_rng(T)
    qkv = torch.from_numpy(rng.normal(size=(B, T, 3 * heads * D)).astype(
        np.float32)).bfloat16()
    got = attention_in_kernel_order(qkv, heads)
    want = CA.clip_attention_core_plain(qkv, heads)
    assert got.dtype == torch.bfloat16
    assert (got == want).float().mean() > 0.97
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=2 ** -7)


@pytest.mark.parametrize("gain", [1.0, 30.0])
def test_kernel_order_matches_plain_f32(gain):
    """f32 at the card tests' tolerance, also with logits scaled x30 (rows
    close to one-hot, most p underflowing to 0)."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(size=(2, 77, 3 * 128)).astype(
        np.float32))
    qkv[..., :128] *= gain
    got = attention_in_kernel_order(qkv, 2)
    want = CA.clip_attention_core_plain(qkv, 2)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_rounding_unnormalised_p_would_differ():
    """Why the order matters: rounding e before the division (the flash
    kernels' order) gives other bf16 probabilities than the plain version
    in a large share of places."""
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy(rng.normal(size=(2, 50, 3 * 64)).astype(
        np.float32)).bfloat16()
    q, k, _ = (t.float() for t in qkv.split(64, dim=-1))
    s = (q @ k.transpose(-1, -2)) * 64 ** -0.5
    e = torch.exp(s - s.max(-1, keepdim=True).values)
    late = (e.bfloat16().float() / e.sum(-1, keepdim=True)).bfloat16()
    early = torch.softmax(s, dim=-1).bfloat16()
    assert (late != early).float().mean() > 0.05


def test_forward_shared_memory_budget():
    """The wrapper's budget is the kernel's layout: ViT-B/32 in bf16 is
    27,648 bytes a block, and T = 400 fits in bf16 but not in f32."""
    assert CA._fwd_smem_bytes(50, 64, 2) == 64 * (72 + 72 + 72) * 2 == 27_648
    assert CA._fwd_smem_bytes(50, 64, 4) == 64 * (72 + 72 + 68) * 4
    assert CA._fwd_smem_bytes(77, 32, 2) == 128 * (40 + 40 + 40) * 2
    assert CA._fwd_smem_bytes(400, 64, 2) <= CA.MAX_SMEM
    assert CA._fwd_smem_bytes(400, 64, 4) > CA.MAX_SMEM


# ------------------------------------------ B5: the backward, lane by lane --

# chip_smoke.py's BWD_TOLS: (atol, rtol) of B5 against the plain backward.
BWD_TOLS = {torch.bfloat16: (1e-3, 2 ** -7), torch.float32: (2e-4, 1e-4)}


def dots_nt(xs, x0, ys, y0, kN, bf16, nk16, nd8):
    """``dots_nt`` of clip_attention.cu: the 16 rows of ``xs`` from ``x0``
    (A fragments) times the 8 kN rows of ``ys`` from ``y0`` (B fragments)
    → [kN, 32, 4] accumulators."""
    s = np.zeros((kN, 32, 4), np.float32)
    mi = LANES >> 3
    if bf16:
        arow = x0 + (LANES & 7) + np.where(mi & 1, 8, 0)
        acol = np.where(mi & 2, 8, 0)
        krow = y0 + (LANES & 7) + np.where(mi & 2, 8, 0)
        kcol = np.where(mi & 1, 8, 0)
        for kc in range(nk16):
            a = ldmatrix_x4(xs, arow, kc * 16 + acol)
            for np_ in range(kN // 2):
                kb = ldmatrix_x4(ys, np_ * 16 + krow, kc * 16 + kcol)
                s[2 * np_] += mma_m16n8k16(a, kb[:, 0:2])
                s[2 * np_ + 1] += mma_m16n8k16(a, kb[:, 2:4])
    else:
        for kc in range(nd8):
            c = kc * 8 + 2 * TQ
            a = np.stack([xs[x0 + GQ, c], xs[x0 + GQ + 8, c],
                          xs[x0 + GQ, c + 1], xs[x0 + GQ + 8, c + 1]], axis=1)
            for n in range(kN):
                r = y0 + n * 8 + GQ
                s[n] += mma_m16n8k8(a, np.stack([ys[r, c], ys[r, c + 1]],
                                                axis=1))
    return s


def acc_nn(o, p, ys, y0, bf16, nk16, split=True):
    """``acc_nn`` of clip_attention.cu: o += P Y with P in the accumulators
    ``p`` [kN, 32, 4] as the A fragment and Y the 8 kN rows of ``ys`` from
    ``y0``. bf16 with ``split``: hi = bf16(p), lo = bf16(p - hi), two mma."""
    kN = p.shape[0]
    mi = LANES >> 3
    if bf16:
        vrow = y0 + (LANES & 7) + np.where(mi & 1, 8, 0)
        vcol = np.where(mi & 2, 8, 0)
        hi = _bf16(p)
        parts = [_bf16(p - hi), hi] if split else [hi]
        for kc in range(kN // 2):
            for part in parts:
                a = np.stack([part[2 * kc][:, 0:2], part[2 * kc][:, 2:4],
                              part[2 * kc + 1][:, 0:2],
                              part[2 * kc + 1][:, 2:4]], axis=1)
                for dp in range(nk16):
                    vb = ldmatrix_x4(ys, kc * 16 + vrow, dp * 16 + vcol,
                                     trans=True)
                    o[2 * dp] += mma_m16n8k16(a, vb[:, 0:2])
                    o[2 * dp + 1] += mma_m16n8k16(a, vb[:, 2:4])
    else:
        for n in range(kN):
            a = np.stack([p[n][:, 0], p[n][:, 2], p[n][:, 1], p[n][:, 3]],
                         axis=1)
            r = y0 + n * 8 + 2 * TQ
            for dp in range(nk16):
                c = 2 * GQ + 16 * dp
                o[2 * dp] += mma_m16n8k8(a, np.stack(
                    [ys[r, c], ys[r + 1, c]], axis=1))
                o[2 * dp + 1] += mma_m16n8k8(a, np.stack(
                    [ys[r, c + 1], ys[r + 1, c + 1]], axis=1))


def rows_from_accumulators(o, mul, bf16, nk16, nd8, kD):
    """The 16 x kD values of the accumulators ``o`` times ``mul`` by the
    (row, dim) map that ``stage_rows`` and the dq store share; NaN where
    nothing is written."""
    out = np.full((16, kD), np.nan, np.float32)
    val = o * np.float32(mul)
    if bf16:
        for dt in range(nd8):
            c = dt * 8 + 2 * TQ
            for j in range(2):
                out[GQ, c + j] = _bf16(val[dt][:, j])
                out[GQ + 8, c + j] = _bf16(val[dt][:, 2 + j])
    else:
        for dp in range(nk16):
            c = dp * 16 + 4 * TQ
            for half in range(2):
                out[GQ + 8 * half, c] = val[2 * dp][:, 2 * half]
                out[GQ + 8 * half, c + 1] = val[2 * dp + 1][:, 2 * half]
                out[GQ + 8 * half, c + 2] = val[2 * dp][:, 2 * half + 1]
                out[GQ + 8 * half, c + 3] = val[2 * dp + 1][:, 2 * half + 1]
    return out


def emulate_attention_bwd_block(q, k, v, g, dtype):
    """One (image, head) of clip_attention.cu's backward, lane by lane: q,
    k, v, g [T, D] in the input type's values → dq, dk, dv [T, D] as
    stored. Shared memory is NaN where the kernel never writes and zero
    where cp.async zero-fills."""
    T, D = q.shape
    bf16 = dtype == torch.bfloat16
    kD = 32 if D <= 32 else 64 if D <= 64 else 128
    ld = kD + 8
    ntiles = -(-T // 64)
    rows = ntiles * 64
    bufs = []
    for src in (q, k, v, g):
        buf = np.full((rows, ld), np.nan)
        buf[:, :kD] = 0.0
        buf[:T, :D] = src
        bufs.append(buf)
    qs, ks, vs, gs = bufs
    st_m, st_l, st_d = (np.full(rows, np.nan, np.float32) for _ in range(3))
    nk16, nd8 = -(-D // 16), D // 8
    scale = np.float32(D ** -0.5)
    c2 = scale * np.float32(1.4426950408889634)
    mtiles = -(-T // 16)
    dq, dk, dv = (np.full((T, D), np.nan, np.float32) for _ in range(3))

    def quad(x, op=np.add):
        x = op(x, x[LANES ^ 1])
        return op(x, x[LANES ^ 2])

    def row_of(e):  # accumulator element -> index of its row half
        return e >> 1

    # Orientation A: a warp owns 16 query rows.
    for mt in range(mtiles):
        r0 = mt * 16

        def logits(t):
            s = dots_nt(qs, r0, ks, t * 64, 8, bf16, nk16, nd8)
            for n in range(8):
                for j in range(2):
                    past = t * 64 + n * 8 + 2 * TQ + j >= T
                    s[n][past, j] = -np.inf
                    s[n][past, 2 + j] = -np.inf
            return s

        def probs(s):
            p = np.zeros_like(s)
            for e in range(4):
                p[:, :, e] = np.exp2((s[:, :, e] - m[row_of(e)]) * c2) \
                    / l[row_of(e)]
            return p

        m = np.full((2, 32), -1e30, np.float32)
        l = np.zeros((2, 32), np.float32)
        with np.errstate(over="ignore"):
            for t in range(ntiles):
                s = logits(t)
                for h in range(2):
                    mx = quad(s[:, :, 2 * h: 2 * h + 2].max(axis=(0, 2)),
                              np.maximum)
                    m_new = np.maximum(m[h], mx)
                    l[h] *= np.exp2((m[h] - m_new) * c2)
                    m[h] = m_new
                for n in range(8):
                    for e in range(4):
                        l[row_of(e)] += np.exp2((s[n][:, e] - m[row_of(e)])
                                                * c2)
        l = np.stack([quad(l[0]), quad(l[1])])
        delta = np.zeros((2, 32), np.float32)
        for t in range(ntiles):
            if ntiles > 1:
                s = logits(t)
            s = probs(s)
            dp = dots_nt(gs, r0, vs, t * 64, 8, bf16, nk16, nd8)
            for n in range(8):
                for e in range(4):
                    delta[row_of(e)] += dp[n][:, e] * s[n][:, e]
        delta = np.stack([quad(delta[0]), quad(delta[1])])
        for h in range(2):
            lanes = TQ == 0
            st_m[r0 + GQ[lanes] + 8 * h] = m[h][lanes]
            st_l[r0 + GQ[lanes] + 8 * h] = l[h][lanes]
            st_d[r0 + GQ[lanes] + 8 * h] = delta[h][lanes]
        o = np.zeros((kD // 8, 32, 4), np.float32)
        for t in range(ntiles):
            if ntiles > 1:
                s = probs(logits(t))
                dp = dots_nt(gs, r0, vs, t * 64, 8, bf16, nk16, nd8)
            dl = np.zeros_like(s)
            for e in range(4):
                dl[:, :, e] = s[:, :, e] * (dp[:, :, e] - delta[row_of(e)])
            acc_nn(o, dl, ks, t * 64, bf16, nk16)
        staged = rows_from_accumulators(o, scale, bf16, nk16, nd8, kD)
        for r in range(16):
            if r0 + r < T:
                dq[r0 + r] = staged[r, :D]

    # Orientation B: a warp owns 16 keys, 16 queries at a time.
    for kt in range(mtiles):
        r0 = kt * 16
        acc_k = np.zeros((kD // 8, 32, 4), np.float32)
        acc_v = np.zeros((kD // 8, 32, 4), np.float32)
        for qc in range(mtiles):
            st = dots_nt(ks, r0, qs, qc * 16, 2, bf16, nk16, nd8)
            dpt = dots_nt(vs, r0, gs, qc * 16, 2, bf16, nk16, nd8)
            with np.errstate(invalid="ignore", over="ignore"):
                for n in range(2):
                    for e in range(4):
                        j = qc * 16 + n * 8 + 2 * TQ + (e & 1)
                        ok = (j < T) & (r0 + GQ + 8 * (e >> 1) < T)
                        p = np.exp2((st[n][:, e] - st_m[j]) * c2) / st_l[j]
                        st[n][:, e] = np.where(ok, p, 0.0)
                        dpt[n][:, e] = np.where(
                            ok, p * (dpt[n][:, e] - st_d[j]), 0.0)
            acc_nn(acc_v, st, gs, qc * 16, bf16, nk16)
            acc_nn(acc_k, dpt, qs, qc * 16, bf16, nk16)
        # Staged in the warp's own k and v rows, then the row copies.
        ks[r0:r0 + 16, :kD] = rows_from_accumulators(acc_k, scale, bf16,
                                                     nk16, nd8, kD)
        vs[r0:r0 + 16, :kD] = rows_from_accumulators(acc_v, 1.0, bf16, nk16,
                                                     nd8, kD)
        for r in range(16):
            if r0 + r < T:
                dk[r0 + r] = ks[r0 + r, :D]
                dv[r0 + r] = vs[r0 + r, :D]
    return dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,D", [(17, 32), (50, 32), (77, 32), (17, 64),
                                 (50, 64), (77, 64)])
def test_attention_bwd_fragments_match_plain_and_pallas(dtype, T, D):
    """The backward's index maps through the PTX layouts, one key tile
    (T <= 64) and two (T = 77): every stored element written, no NaN from
    unwritten or padded shared memory, and the values of the plain backward
    and of the JAX package's Pallas kernel in interpret mode, both at the
    card's tolerance for B5 against its plain version."""
    rng = np.random.default_rng(T * D + 1)
    qkv = torch.from_numpy(rng.normal(size=(1, T, 3 * D)).astype(np.float32)
                           ).to(dtype)
    dout = torch.from_numpy(rng.normal(size=(1, T, D)).astype(np.float32)
                            ).to(dtype)
    q, k, v = (t[0].float().numpy() for t in qkv.split(D, dim=-1))
    got = np.concatenate(emulate_attention_bwd_block(
        q, k, v, dout[0].float().numpy(), dtype), axis=1)
    assert np.isfinite(got).all()
    atol, rtol = BWD_TOLS[dtype]
    want = CA.clip_attention_core_bwd_plain(qkv, dout, heads=1)[0]
    np.testing.assert_allclose(got, want.float().numpy(), atol=atol,
                               rtol=rtol)
    np_dtype = ml_dtypes.bfloat16 if dtype == torch.bfloat16 else np.float32
    jax_want = np.asarray(_pallas_attn_bwd(
        jnp.asarray(qkv.float().numpy().astype(np_dtype)),
        jnp.asarray(dout.float().numpy().astype(np_dtype)), 1,
        interpret=True)).astype(np.float32)[0]
    np.testing.assert_allclose(got, jax_want, atol=atol, rtol=rtol)


def test_rounding_p_to_bf16_once_would_leave_the_f32_contract():
    """Why the A fragments of dv, dq and dk are split into bf16 hi + lo:
    with p and dl rounded to bf16 once, the f32 values before the store are
    2^-9 of a term off, hundreds of times what the split leaves, and the
    backward would no longer be the plain version's function (which, as the
    Pallas kernel, keeps p in f32 and rounds once, at the store)."""
    rng = np.random.default_rng(21)
    T, D = 50, 64
    q, k, v, g = (_bf16(rng.normal(size=(T, D))) for _ in range(4))
    s = (q @ k.T).astype(np.float32) * np.float32(D ** -0.5)
    e = np.exp(s - s.max(1, keepdims=True))
    p = (e / e.sum(1, keepdims=True)).astype(np.float32)
    exact = p.astype(np.float64).T @ g.astype(np.float64)
    hi = _bf16(p)
    lo = _bf16(p - hi)
    once = hi.astype(np.float64).T @ g
    split = once + lo.astype(np.float64).T @ g
    scale = np.abs(exact).max()
    assert np.abs(split - exact).max() / scale < 2 ** -17
    assert np.abs(once - exact).max() / scale > 2e-4
    assert np.abs(once - exact).max() > 100 * np.abs(split - exact).max()


def test_backward_shared_memory_budget():
    """The wrapper's budget is the kernel's layout: four slices at the
    forward's Q/K stride plus three f32 statistics per row. ViT-B/32 in
    bf16 is 37,632 bytes a block; T = 384 at D = 64 fits in bf16 and not in
    f32."""
    assert CA._bwd_smem_bytes(50, 64, 2) == 64 * 4 * 72 * 2 + 3 * 64 * 4 \
        == 37_632
    assert CA._bwd_smem_bytes(50, 64, 4) == 64 * 4 * 72 * 4 + 768 == 74_496
    assert CA._bwd_smem_bytes(77, 32, 2) == 128 * 4 * 40 * 2 + 3 * 128 * 4
    assert CA._bwd_smem_bytes(50, 128, 4) == 64 * 4 * 136 * 4 + 768
    assert CA._bwd_smem_bytes(384, 64, 2) <= CA.MAX_SMEM
    assert CA._bwd_smem_bytes(384, 64, 4) > CA.MAX_SMEM
    assert CA._bwd_smem_bytes(385, 64, 2) > CA.MAX_SMEM


# --------------------------------------- B3: m16n8k32.s8 and the int4 scan --

def mma_m16n8k32(a, b):
    """PTX mma.m16n8k32 (s8): a [..., 32, 4, 4], b [..., 32, 2, 4] per-lane
    registers of four signed bytes (lowest byte first) → c [..., 32, 4]
    int32, one product per leading index (a warp each). A(16x32):
    a0 (gq, 4tq..+3), a1 (gq+8, 4tq..), a2 (gq, 16+4tq..), a3 (gq+8,
    16+4tq..). B(32x8): b0 (k 4tq..+3, n gq), b1 (k 16+4tq.., n gq).
    C(16x8) as the other shapes."""
    A = np.zeros(a.shape[:-3] + (16, 32), np.int64)
    B = np.zeros(b.shape[:-3] + (32, 8), np.int64)
    for i in range(4):
        A[..., GQ, 4 * TQ + i] = a[..., 0, i]
        A[..., GQ + 8, 4 * TQ + i] = a[..., 1, i]
        A[..., GQ, 16 + 4 * TQ + i] = a[..., 2, i]
        A[..., GQ + 8, 16 + 4 * TQ + i] = a[..., 3, i]
        B[..., 4 * TQ + i, GQ] = b[..., 0, i]
        B[..., 16 + 4 * TQ + i, GQ] = b[..., 1, i]
    C = A @ B
    return np.stack([C[..., GQ, 2 * TQ], C[..., GQ, 2 * TQ + 1],
                     C[..., GQ + 8, 2 * TQ], C[..., GQ + 8, 2 * TQ + 1]],
                    axis=-1)


def _low_biased(w):
    """int4_scan.cu's ``low_biased`` on uint32 words: lo + 8 per byte."""
    return w.astype(np.uint32) & np.uint32(0x0F0F0F0F)


def _high_biased(w):
    """``high_biased``: hi + 8 per byte, from the top nibble."""
    return ((w.astype(np.uint32) >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) \
        ^ np.uint32(0x08080808)


def _bytes_of(words):
    """uint32 [...] → the four signed bytes of each word, lowest first."""
    return np.ascontiguousarray(words.astype("<u4")).view(np.int8).reshape(
        words.shape + (4,)).astype(np.int64)


def test_biased_nibble_words_match_unpack_int4():
    """Every byte value through ``low_biased`` / ``high_biased``: the
    values ``unpack_int4`` gives plus 8, all in 0..15, so they are valid
    signed bytes and no byte touches its neighbour."""
    b = np.arange(-128, 128, dtype=np.int8)
    rows = np.stack([b, b[::-1], np.roll(b, 7), np.roll(b, 101)], axis=1)
    words = rows.copy().view("<u4")[:, 0]
    want = S4.unpack_int4(torch.from_numpy(rows)).numpy().astype(np.int64) + 8
    assert want.min() == 0 and want.max() == 15
    np.testing.assert_array_equal(_bytes_of(_low_biased(words)), want[:, :4])
    np.testing.assert_array_equal(_bytes_of(_high_biased(words)),
                                  want[:, 4:])


def emulate_int4_scan(q, packed, scales, pen, blocks):
    """``scan`` of int4_scan.cu lane by lane, with ``blocks`` blocks of 4
    warps in x and one pass of 16 queries per block in y."""
    nq, dim = q.shape
    n = packed.shape[0]
    half = dim // 2
    nchunks = -(-half // 64)
    half_pad = nchunks * 64
    ldq = 2 * half_pad + 64
    out = np.full((nq, n), np.nan, np.float32)
    ngroups = -(-n // 32)
    nwarps = blocks * 4
    flat = packed.reshape(-1).view(np.uint8)
    for q0 in range(0, nq, 16):
        nqb = min(16, nq - q0)
        qs = np.full((16, ldq), 0x5A, np.uint8)  # garbage where unwritten
        for i in range(16 * (2 * half_pad // 16)):
            j, c = divmod(i, 2 * half_pad // 16)
            c *= 16
            d = c if c < half_pad else c - half_pad
            piece = np.zeros(16, np.uint8)
            if j < nqb and d < half:
                lo = (0 if c < half_pad else half) + d
                piece = q[q0 + j, lo:lo + 16].view(np.uint8)
            qs[j, c:c + 16] = piece
        # 8 * sum_d q[j][d] over the padded row (the padding is 0).
        bias = 8 * qs[:, :2 * half_pad].view(np.int8).astype(np.int64).sum(1)
        nquads = -(-nchunks // 4)
        for first in range(min(nwarps, ngroups)):
            mine = -(-(ngroups - first) // nwarps)
            stage = np.full((16, 40), -7, np.int64)
            for s in range(mine * 4 * nquads):
                quad, tile = s % nquads, s // nquads
                grp, i = first + (tile // 4) * nwarps, tile % 4
                r = grp * 32 + i * 8 + GQ
                if quad == 0:
                    acc = np.zeros((32, 4), np.int64)
                for j in range(4):
                    c = quad * 4 + j
                    byte = c * 64 + TQ * 16
                    w = np.zeros((32, 4), np.uint32)  # the load: lane, word
                    for lane in range(32):
                        if r[lane] < n and byte[lane] < half:
                            o = r[lane] * half + byte[lane]
                            w[lane] = flat[o:o + 16].view("<u4")
                    if c >= nchunks:
                        assert not w.any()
                        continue
                    # A: 16 bytes of queries gq and gq + 8 in each half.
                    la, lb, ha, hb = (np.stack(
                        [qs[row[lane], off[lane]:off[lane] + 16].view("<u4")
                         for lane in range(32)])
                        for row, off in ((GQ, byte), (GQ + 8, byte),
                                         (GQ, byte + half_pad),
                                         (GQ + 8, byte + half_pad)))
                    frags = [np.stack([x[:, k], y[:, k], x[:, k + 1],
                                       y[:, k + 1]], axis=1)
                             for x, y in ((la, lb), (ha, hb)) for k in (0, 2)]
                    al0, al1, ah0, ah1 = (_bytes_of(f) for f in frags)
                    for a, unpack, k in ((al0, _low_biased, 0),
                                         (al1, _low_biased, 2),
                                         (ah0, _high_biased, 0),
                                         (ah1, _high_biased, 2)):
                        b = np.stack([unpack(w[:, k]), unpack(w[:, k + 1])],
                                     axis=1)
                        acc += mma_m16n8k32(a, _bytes_of(b))
                if quad != nquads - 1:
                    continue
                for j in range(2):
                    stage[GQ, i * 8 + 2 * TQ + j] = acc[:, j]
                    stage[GQ + 8, i * 8 + 2 * TQ + j] = acc[:, 2 + j]
                if i != 3:
                    continue
                r = grp * 32 + LANES
                live = r < n
                for j in range(nqb):
                    val = (stage[j, LANES] - bias[j]).astype(np.float32)
                    res = (val * scales[np.minimum(r, n - 1)]).astype(
                        np.float32) + pen[np.minimum(r, n - 1)]
                    assert np.isnan(out[q0 + j, r[live]]).all()
                    out[q0 + j, r[live]] = res[live]
                stage[:] = -7
    return out


def _int4_case(nq, n, dim, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (nq, dim), dtype=np.int8)
    q[:, dim // 2:] = rng.integers(-127, 128, (nq, dim // 2),
                                   dtype=np.int8) // 3
    packed = rng.integers(-128, 128, (n, dim // 2), dtype=np.int8)
    scales = (rng.random(n) * 0.2 + 1e-3).astype(np.float32)
    pen = np.where(rng.random(n) < 0.1, -1e30, 0.0).astype(np.float32)
    return q, packed, scales, pen


@pytest.mark.parametrize("nq,n,dim,blocks", [
    (16, 70, 512, 1), (1, 33, 32, 2), (17, 64, 64, 1), (40, 100, 160, 2),
    (3, 300, 1024, 1), (16, 1, 96, 3)])
def test_int4_scan_fragments_bit_exact_vs_plain(nq, n, dim, blocks):
    """The scan's loads, unpack, A/B fragments, staging and masks through
    the PTX layout of m16n8k32: every score written exactly once and equal
    bit for bit to the plain scan; ragged N, ``nq`` other than 16, dims
    that are no multiple of 128 (a last chunk partly past the row) or take
    two steps a tile (1024), and warps that walk several groups."""
    q, packed, scales, pen = _int4_case(nq, n, dim, nq * n + dim)
    got = emulate_int4_scan(q, packed, scales, pen, blocks)
    want = S4.int4_scan_scores_plain(*(torch.from_numpy(a) for a in (
        q, packed, scales, pen))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nq,n,dim", [(16, 256, 64), (5, 512, 32)])
def test_int4_scan_fragments_bit_exact_vs_pallas_interpret(nq, n, dim):
    q, packed, scales, pen = _int4_case(nq, n, dim, n + dim)
    got = emulate_int4_scan(q, packed, scales, pen, blocks=2)
    want = np.asarray(jax_int4_scan(*(jnp.asarray(a) for a in (
        q, packed, scales, pen)), interpret=True))
    np.testing.assert_array_equal(got, want)


def test_int4_scan_shared_memory_budget():
    """The wrapper's budget is the kernel's layout: 16 query rows of two
    64-dim-padded halves plus 64 bytes, 16 int32 biases, and four 16 x 40
    int32 stages."""
    assert S4._smem_bytes(512) == 16 * (512 + 64) + 64 + 10_240 == 19_520
    assert S4._smem_bytes(32) == 16 * (128 + 64) + 64 + 10_240
    assert S4._smem_bytes(160) == 16 * (256 + 64) + 64 + 10_240
    assert S4._smem_bytes(8192) <= S4.MAX_SMEM < S4._smem_bytes(16384)


# ------------------------------------- B2: the int8 scan on m16n8k32.s8 --

def emulate_int8_scan(q, rows, pen, blocks, piece=16, loads=8):
    """``scan`` of int8_scan.cu lane by lane, with ``blocks`` blocks of 4
    warps in x and one pass of 16 queries per block in y; ``piece`` is the
    bytes a lane loads (``kPiece``), ``loads`` the chunks a step
    (``kLoads``). The warps of a pass step together, each on its own
    groups; a warp whose steps are done loads nothing."""
    nq, dim = q.shape
    n = rows.shape[0]
    chunk = 4 * piece
    nchunks = -(-dim // chunk)
    ldq = -(-(nchunks * chunk) // 128) * 128 + chunk
    assert ldq % 128 == chunk
    if piece == 16:
        assert 16 * ldq + 4 * 16 * 40 * 4 == S8._smem_bytes(dim)
    out = np.full((nq, n), np.nan, np.float32)
    ngroups = -(-n // 32)
    nwarps = blocks * 4
    nsteps = -(-nchunks // loads)
    flat = rows.reshape(-1).view(np.uint8)
    for q0 in range(0, nq, 16):
        nqb = min(16, nq - q0)
        qs = np.full((16, ldq), 0x5A, np.uint8)  # garbage where unwritten
        row16 = (ldq - chunk) // 16
        for i in range(16 * row16):
            j, c = divmod(i, row16)
            c *= 16
            qs[j, c:c + 16] = q[q0 + j, c:c + 16].view(np.uint8) \
                if j < nqb and c < dim else 0
        first = np.arange(min(nwarps, ngroups))  # the warps that have groups
        steps = -(-(ngroups - first) // nwarps) * 4 * nsteps
        stage = np.full((len(first), 16, 40), -7, np.int64)
        acc = np.zeros((len(first), 32, 4), np.int64)
        for s in range(steps.max()):
            live = s < steps
            step, tile = s % nsteps, s // nsteps
            grp, i = first + (tile // 4) * nwarps, tile % 4
            r = grp[:, None] * 32 + i * 8 + GQ  # [warp, lane]
            if step == 0:
                acc[:] = 0
            for j in range(loads):
                c = step * loads + j
                byte = c * chunk + TQ * piece
                ok = live[:, None] & (r < n) & (byte < dim)
                # No load reads past the end of its row or the last row.
                assert (byte + piece <= dim)[ok.any(0)].all()
                at = np.where(ok, r * dim + byte, 0)[..., None] \
                    + np.arange(piece)
                w = np.where(ok[..., None], flat[at], 0).astype(
                    np.uint8).view("<u4")  # the load: warp, lane, word
                if c >= nchunks:
                    assert not w.any()
                    continue
                # A: the same bytes of queries gq and gq + 8.
                qa = c * chunk + TQ * piece
                wa, wb = (np.stack([qs[row[lane], qa[lane]:qa[lane] + piece]
                                    for lane in range(32)]).view("<u4")
                          for row in (GQ, GQ + 8))
                for m in range(0, piece // 4, 2):
                    a = np.stack([wa[:, m], wb[:, m], wa[:, m + 1],
                                  wb[:, m + 1]], axis=1)
                    b = np.stack([w[..., m], w[..., m + 1]], axis=-1)
                    acc += np.where(live[:, None, None], mma_m16n8k32(
                        _bytes_of(a), _bytes_of(b)), 0)
            if step != nsteps - 1:
                continue
            ws = np.flatnonzero(live)[:, None]
            for k in range(2):
                stage[ws, GQ, i * 8 + 2 * TQ + k] = acc[live, :, k]
                stage[ws, GQ + 8, i * 8 + 2 * TQ + k] = acc[live, :, 2 + k]
            if i != 3:
                continue
            rr = grp[:, None] * 32 + LANES
            mine = live[:, None] & (rr < n)
            for j in range(nqb):
                res = stage[:, j, LANES].astype(np.float32) \
                    + pen[np.minimum(rr, n - 1)]
                assert np.isnan(out[q0 + j, rr[mine]]).all()
                out[q0 + j, rr[mine]] = res[mine]
            stage[live] = -7
    return out


def _int8_case(nq, n, dim, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (nq, dim), dtype=np.int8)
    rows = rng.integers(-127, 128, (n, dim), dtype=np.int8)
    pen = np.where(rng.random(n) < 0.1, -1e30, 0.0).astype(np.float32)
    return q, rows, pen


@pytest.mark.parametrize("dim", [16, 48, 512, 768, 1040])
@pytest.mark.parametrize("n", [1, 7, 8, 33, 4099])
@pytest.mark.parametrize("nq", [1, 5, 16, 17, 40])
def test_int8_scan_fragments_bit_exact_vs_plain(nq, n, dim):
    """The scan's loads, k order, A/B fragments, staging and masks through
    the PTX layout of m16n8k32: every score written exactly once and equal
    bit for bit to the plain scan; a ragged last group, ``nq`` other than
    16 (passes over y), dims that end inside a 64-byte chunk (16, 48, 1040)
    or take more than one step a tile (768, 1040), and, at 4,099 rows,
    warps that walk several groups."""
    q, rows, pen = _int8_case(nq, n, dim, nq * n + dim)
    got = emulate_int8_scan(q, rows, pen, blocks=2 if n > 100 else 1)
    want = S8.int8_scan_scores_plain(*(torch.from_numpy(a) for a in (
        q, rows, pen))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nq,n,dim,piece,loads", [
    (17, 300, 512, 8, 8), (5, 99, 1040, 8, 4), (16, 70, 512, 16, 4),
    (3, 260, 768, 16, 3)])
def test_int8_scan_fragments_hold_for_other_pieces_and_steps(
        nq, n, dim, piece, loads):
    """The same index expressions with 8-byte pieces (``kPiece`` of the
    ``int2`` variant) or fewer chunks a step (``kLoads``), as
    ``csrc/variants.py`` builds them."""
    q, rows, pen = _int8_case(nq, n, dim, n + dim)
    got = emulate_int8_scan(q, rows, pen, blocks=1, piece=piece, loads=loads)
    want = S8.int8_scan_scores_plain(*(torch.from_numpy(a) for a in (
        q, rows, pen))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nq,n,dim", [(1, 7, 16), (17, 33, 48),
                                      (16, 256, 512), (5, 8, 1040)])
def test_int8_scan_fragments_bit_exact_vs_pallas_interpret(nq, n, dim):
    q, rows, pen = _int8_case(nq, n, dim, n + dim)
    got = emulate_int8_scan(q, rows, pen, blocks=2)
    want = np.asarray(jax_int8_scan(*(jnp.asarray(a) for a in (
        q, rows, pen)), tile_rows=n, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_int8_scan_shared_memory_budget():
    """The wrapper's budget is the kernel's layout: 16 query rows padded to
    64 dims and rounded up to 128 bytes, plus 64 bytes, and four 16 x 40
    int32 stages. Every D that the exactness check lets through (up to
    1,040) fits."""
    assert S8._smem_bytes(512) == 16 * (512 + 64) + 10_240 == 19_456
    assert S8._smem_bytes(48) == 16 * (128 + 64) + 10_240
    assert S8._smem_bytes(576) == 16 * (640 + 64) + 10_240
    assert S8._smem_bytes(1040) == 16 * (1152 + 64) + 10_240 == 29_696
    assert S8._smem_bytes(1040) <= S8.MAX_SMEM
