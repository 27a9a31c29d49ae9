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
  two-pass form.
"""

import numpy as np
import pytest
import torch

from retrieval_based_object_detection_tpu_torch.ops import clip_attention as CA
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
