"""The PyTorch port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc; without a GPU they skip. They
import neither JAX nor the JAX package, so on a machine that has only the
port's dependencies they run without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from retrieval_based_object_detection_tpu_torch.ops import attention as A
from retrieval_based_object_detection_tpu_torch.ops import clip_attention as CA
from retrieval_based_object_detection_tpu_torch.ops import int4_scan as S4
from retrieval_based_object_detection_tpu_torch.ops import int8_scan as S
from retrieval_based_object_detection_tpu_torch.ops import medoid as M

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    # Decided here, not at import, so every test worker collects the same
    # tests.
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# bf16: the kernel and the plain version form the same f32 sums in another
# order, so p (≤ 1) and the output may round to neighbouring bf16 values:
# one ulp of p (2⁻⁹ near 0.5) times |v| ≲ 4, plus one ulp of the output.
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 1e-2, 2 ** -7)])
@pytest.mark.parametrize("B,T,heads,D", [(8, 50, 12, 64), (3, 17, 4, 32),
                                         (2, 77, 8, 64),
                                         # the m-tile's and key tile's edges
                                         (2, 16, 3, 64), (2, 49, 3, 64),
                                         (2, 64, 3, 64), (2, 65, 3, 64),
                                         (1, 50, 12, 64), (1, 1, 1, 64),
                                         # the narrowest and widest heads
                                         (3, 50, 5, 8), (2, 50, 2, 128),
                                         (2, 77, 3, 24), (1, 128, 2, 128)])
def test_attention_kernel_matches_plain(cuda_device, dtype, atol, rtol,
                                        B, T, heads, D):
    g = torch.Generator(device="cpu").manual_seed(B * T)
    qkv = torch.randn(B, T, 3 * heads * D, generator=g).to(cuda_device, dtype)
    before = CA.KERNEL.launches
    got = CA.clip_attention_core(qkv, heads=heads)
    torch.cuda.synchronize()
    assert CA.KERNEL.launches == before + 1
    want = CA.clip_attention_core_plain(qkv, heads=heads)
    assert got.dtype == dtype and got.shape == (B, T, heads * D)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _attention_float64(qkv, heads):
    B, T, W3 = qkv.shape
    W = W3 // 3
    q, k, v = (t.double().view(B, T, heads, W // heads).transpose(1, 2)
               for t in qkv.split(W, dim=-1))
    p = torch.softmax(q @ k.transpose(-1, -2) * (W // heads) ** -0.5, dim=-1)
    return (p @ v).transpose(1, 2).reshape(B, T, W)


# Logits scaled x30 (q * 30): rows close to one-hot, most p underflow to 0,
# and at T = 77 the row maximum may lie in either key tile, so pass 1's
# running rescale and its -1e30 start run through the fragments. bf16 keeps
# its tolerance against the plain version. In f32 the raw dots reach ~1000,
# where one f32 rounding is 6e-5, so two correct f32 computations differ by
# more than 1e-5: measured on the H100 the plain version is 2.9e-5 to 4.6e-5
# from a float64 reference at these shapes. There the kernel is held to the
# float64 reference instead: within (1e-5, 1e-5) of it, or as close to it as
# the plain version is.
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-5),
                                             (torch.bfloat16, 1e-2, 2 ** -7)])
@pytest.mark.parametrize("B,T,heads,D", [(4, 50, 12, 64), (2, 77, 4, 64),
                                         (1, 130, 2, 32)])
def test_attention_kernel_large_logits_match_plain(cuda_device, dtype, atol,
                                                   rtol, B, T, heads, D):
    g = torch.Generator(device="cpu").manual_seed(T + D)
    qkv = torch.randn(B, T, 3 * heads * D, generator=g)
    qkv[..., :heads * D] *= 30
    qkv = qkv.to(cuda_device, dtype)
    got = CA.clip_attention_core(qkv, heads=heads)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    want = CA.clip_attention_core_plain(qkv, heads=heads)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        return
    ref = _attention_float64(qkv, heads)
    err = (got.double() - ref).abs()
    err_plain = float((want.double() - ref).abs().max())
    assert bool((err <= atol + rtol * ref.abs()).all()) or \
        float(err.max()) <= err_plain


def test_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    qkv = torch.zeros(2, 50, 3 * 64, device=cuda_device)
    with pytest.raises(TypeError):
        CA.clip_attention_core(qkv.half(), heads=1)
    with pytest.raises(ValueError, match="contiguous"):
        CA.clip_attention_core(qkv.transpose(0, 1), heads=1)
    # One head's q, k and v stay in shared memory in the input type: T = 400
    # at D = 64 fits a block in bf16 (7 key tiles) and not in f32.
    long = torch.randn(1, 400, 3 * 64, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        CA.clip_attention_core(long, heads=1)
    torch.testing.assert_close(
        CA.clip_attention_core(long.bfloat16(), heads=1).float(),
        CA.clip_attention_core_plain(long.bfloat16(), heads=1).float(),
        atol=1e-2, rtol=2 ** -7)
    with pytest.raises(ValueError, match="D=12"):
        CA.clip_attention_core(torch.zeros(1, 50, 3 * 12,
                                           device=cuda_device), heads=1)
    with pytest.raises(ValueError, match="D=136"):
        CA.clip_attention_core(torch.zeros(1, 50, 3 * 136,
                                           device=cuda_device), heads=1)


# B5 against the plain backward. f32: the JAX package's custom-VJP tolerance
# (tests/test_clip_fused_attention.py), for the same f32 sums in another
# order. bf16: both sides compute in f32 and round once at the store, so they
# differ by at most one bf16 ulp (2^-7 relative) where the f32 sums round to
# neighbouring values.
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-4, 1e-4),
                                             (torch.bfloat16, 1e-3, 2 ** -7)])
@pytest.mark.parametrize("B,T,heads,D", [(8, 50, 12, 64), (3, 17, 4, 32),
                                         (2, 77, 8, 64),
                                         # the training shape
                                         (64, 50, 12, 64),
                                         # the 16-row and 64-row tiles' edges
                                         (2, 16, 3, 64), (2, 49, 3, 64),
                                         (2, 64, 3, 64), (2, 65, 3, 64),
                                         (1, 1, 1, 64), (1, 130, 2, 32),
                                         # the narrowest and widest heads
                                         (3, 50, 5, 8), (2, 50, 2, 128),
                                         (2, 77, 3, 24), (1, 128, 2, 32)])
def test_attention_backward_kernel_matches_plain(cuda_device, dtype, atol,
                                                 rtol, B, T, heads, D):
    g = torch.Generator(device="cpu").manual_seed(B * T + 1)
    qkv = torch.randn(B, T, 3 * heads * D, generator=g).to(cuda_device, dtype)
    dout = torch.randn(B, T, heads * D, generator=g).to(cuda_device, dtype)
    before = CA.KERNEL.counts["clip_attention_bwd"]
    got = CA.clip_attention_core_bwd(qkv, dout, heads)
    torch.cuda.synchronize()
    assert CA.KERNEL.counts["clip_attention_bwd"] == before + 1
    want = CA.clip_attention_core_bwd_plain(qkv, dout, heads)
    assert got.dtype == dtype and got.shape == qkv.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    # Every (image, head) owns its slices and nothing is added atomically:
    # a second run gives the same bits.
    assert torch.equal(CA.clip_attention_core_bwd(qkv, dout, heads), got)


def _attention_bwd_float64(qkv, dout, heads):
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


# Against float64, at unit logits and at logits x30 (q * 30: rows close to
# one-hot, most p underflow to 0, and at T = 77 the row maximum may lie in
# either key tile). The kernel may be no farther from float64 than twice the
# plain version plus the tolerance's absolute part (times 3 at logits x30,
# where dk grows with q); in bf16 both are dominated by the one rounding at
# the store.
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-4),
                                        (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("gain", [1.0, 30.0])
@pytest.mark.parametrize("B,T,heads,D", [(4, 50, 12, 64), (2, 77, 4, 64),
                                         (1, 130, 2, 32), (2, 50, 2, 128)])
def test_attention_backward_kernel_vs_float64(cuda_device, dtype, atol, gain,
                                              B, T, heads, D):
    g = torch.Generator(device="cpu").manual_seed(T + D + 5)
    qkv = torch.randn(B, T, 3 * heads * D, generator=g)
    qkv[..., :heads * D] *= gain
    qkv = qkv.to(cuda_device, dtype)
    dout = torch.randn(B, T, heads * D, generator=g).to(cuda_device, dtype)
    got = CA.clip_attention_core_bwd(qkv, dout, heads)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    ref = _attention_bwd_float64(qkv, dout, heads)
    plain = CA.clip_attention_core_bwd_plain(qkv, dout, heads)
    err = float((got.double() - ref).abs().max())
    err_plain = float((plain.double() - ref).abs().max())
    assert err <= 2 * err_plain + atol * max(1.0, gain / 10)


def test_attention_autograd_runs_b1_then_b5(cuda_device):
    """Autograd through the core: one B1 launch forward, one B5 launch
    backward, and the gradient is B5's own result."""
    g = torch.Generator(device="cpu").manual_seed(3)
    qkv = torch.randn(4, 50, 3 * 128, generator=g).to(cuda_device)
    dout = torch.randn(4, 50, 128, generator=g).to(cuda_device)
    fwd, bwd = (CA.KERNEL.counts[k] for k in ("clip_attention_fwd",
                                               "clip_attention_bwd"))
    x = qkv.clone().requires_grad_(True)
    out = CA.clip_attention_core(x, heads=2)
    grad, = torch.autograd.grad(out, x, dout)
    torch.cuda.synchronize()
    assert CA.KERNEL.counts["clip_attention_fwd"] == fwd + 1
    assert CA.KERNEL.counts["clip_attention_bwd"] == bwd + 1
    assert torch.equal(out.detach(), CA.clip_attention_core(qkv, 2))
    assert torch.equal(grad, CA.clip_attention_core_bwd(qkv, dout, 2))


def test_attention_backward_rejects_what_it_does_not_take(cuda_device):
    qkv = torch.zeros(2, 50, 3 * 64, device=cuda_device)
    dout = torch.zeros(2, 50, 64, device=cuda_device)
    with pytest.raises(TypeError):
        CA.clip_attention_core_bwd(qkv.half(), dout.half(), heads=1)
    with pytest.raises(ValueError, match="dout"):
        CA.clip_attention_core_bwd(qkv, dout.bfloat16(), heads=1)
    # q, k, v and dO of one head stay in shared memory in the input type:
    # T = 384 at D = 64 fits a block in bf16 (6 tiles of 64) and not in f32.
    long = torch.randn(1, 384, 3 * 64, device=cuda_device)
    dlong = torch.randn(1, 384, 64, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        CA.clip_attention_core_bwd(long, dlong, heads=1)
    torch.testing.assert_close(
        CA.clip_attention_core_bwd(long.bfloat16(), dlong.bfloat16(),
                                   heads=1).float(),
        CA.clip_attention_core_bwd_plain(long.bfloat16(), dlong.bfloat16(),
                                         heads=1).float(),
        atol=1e-3, rtol=2 ** -7)
    with pytest.raises(ValueError, match="D=12"):
        CA.clip_attention_core_bwd(
            torch.zeros(1, 50, 3 * 12, device=cuda_device),
            torch.zeros(1, 50, 12, device=cuda_device), heads=1)
    with pytest.raises(ValueError, match="D=136"):
        CA.clip_attention_core_bwd(
            torch.zeros(1, 50, 3 * 136, device=cuda_device),
            torch.zeros(1, 50, 136, device=cuda_device), heads=1)
    # A view that starts 4 bytes into an allocation: the 16-byte copies
    # need aligned rows.
    flat = torch.zeros(2 * 50 * 64 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        CA.clip_attention_core_bwd(qkv, flat[1:].view(2, 50, 64), heads=1)
    flat3 = torch.zeros(2 * 50 * 192 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        CA.clip_attention_core_bwd(flat3[1:].view(2, 50, 192), dout, heads=1)


def _qkv_bias(device, dtype, B, H, gh, gw, D, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    T = gh * gw
    q, k, v = (torch.randn(B, H, T, D, generator=g).to(device, dtype)
               for _ in range(3))
    bh = torch.randn(B, H, T, gh, generator=g).to(device)
    bw = torch.randn(B, H, T, gw, generator=g).to(device)
    return q, k, v, bh, bw


# B6/B7 against the plain einsum oracle. f32: the same f32 sums in another
# order over up to 4,096 keys. bf16: the kernel rounds each unnormalised p to
# bf16 before the PV product (as the Pallas kernel does) where the oracle
# keeps p in f32 — at most 2^-9 of the largest |v| (about 4) — plus one bf16
# ulp of the output: B1's bf16 tolerance.
FLASH_TOLS = [(torch.float32, 1e-4, 1e-5), (torch.bfloat16, 1e-2, 2 ** -7)]


@pytest.mark.parametrize("dtype,atol,rtol", FLASH_TOLS)
@pytest.mark.parametrize("B,H,gh,gw,D", [(4, 3, 14, 14, 64), (2, 2, 7, 9, 64),
                                         (1, 2, 64, 64, 64),
                                         (2, 1, 7, 9, 16), (1, 2, 14, 14, 96),
                                         (2, 2, 9, 7, 64), (1, 3, 13, 10, 64),
                                         (2, 2, 13, 10, 8), (1, 2, 9, 7, 24),
                                         (1, 1, 13, 10, 128)])
def test_flash_2d_bias_kernel_matches_plain(cuda_device, dtype, atol, rtol,
                                            B, H, gh, gw, D):
    q, k, v, bh, bw = _qkv_bias(cuda_device, dtype, B, H, gh, gw, D,
                                seed=gh * gw + D)
    before = A.KERNEL.counts[A.B6]
    got = A.flash_attention_2d_bias(q, k, v, bh, bw, gh, gw)
    torch.cuda.synchronize()
    assert A.KERNEL.counts[A.B6] == before + 1
    want = A.flash_attention_2d_bias_plain(q, k, v, bh, bw, gh, gw)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype,atol,rtol", FLASH_TOLS)
@pytest.mark.parametrize("B,H,T,D", [(2, 3, 1000, 64), (1, 2, 77, 40),
                                     (1, 1, 4096, 128), (2, 2, 63, 64),
                                     (2, 2, 65, 64), (1, 3, 127, 64),
                                     (1, 3, 129, 64), (2, 1, 129, 8),
                                     (1, 2, 65, 24)])
def test_flash_kernel_matches_plain(cuda_device, dtype, atol, rtol, B, H, T,
                                    D):
    g = torch.Generator(device="cpu").manual_seed(T + D)
    q, k, v = (torch.randn(B, H, T, D, generator=g).to(cuda_device, dtype)
               for _ in range(3))
    before = A.KERNEL.counts[A.B7]
    got = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert A.KERNEL.counts[A.B7] == before + 1
    torch.testing.assert_close(got.float(),
                               A.flash_attention_plain(q, k, v).float(),
                               atol=atol, rtol=rtol)


# Logits scaled ×30 (q·30): row maxima jump between key tiles, so the
# online rescale by exp(m_prev − m_new) and the −1e30 start run through the
# fragments, and most p underflow to 0.
@pytest.mark.parametrize("dtype,atol,rtol", FLASH_TOLS)
@pytest.mark.parametrize("B,H,gh,gw,D", [(1, 2, 64, 64, 64), (2, 2, 13, 10, 64),
                                         (1, 2, 9, 7, 96)])
def test_flash_kernels_large_logits_match_plain(cuda_device, dtype, atol,
                                                rtol, B, H, gh, gw, D):
    q, k, v, bh, bw = _qkv_bias(cuda_device, torch.float32, B, H, gh, gw, D,
                                seed=7 * gh + D)
    q, k, v = (q * 30).to(dtype), k.to(dtype), v.to(dtype)
    got = A.flash_attention_2d_bias(q, k, v, bh * 30, bw, gh, gw)
    got7 = A.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and \
        torch.isfinite(got7.float()).all()
    torch.testing.assert_close(
        got.float(), A.flash_attention_2d_bias_plain(q, k, v, bh * 30, bw, gh,
                                                     gw).float(),
        atol=atol, rtol=rtol)
    torch.testing.assert_close(
        got7.float(), A.flash_attention_plain(q, k, v).float(), atol=atol,
        rtol=rtol)


@pytest.mark.parametrize("which", ["q", "k", "v", "bias_h", "bias_w"])
def test_flash_kernels_refuse_to_cut_the_autograd_graph(cuda_device, which):
    """B6/B7 have no backward and write through a raw pointer: with a
    gradient being recorded they raise, naming the einsum path, rather than
    return an output without a grad_fn. Under no_grad they run."""
    names = ("q", "k", "v", "bias_h", "bias_w")
    tensors = dict(zip(names, _qkv_bias(cuda_device, torch.float32, 1, 2, 4,
                                        4, 64, 1)))
    tensors[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="use_flash=False"):
        A.flash_attention_2d_bias(*tensors.values(), 4, 4)
    if which in ("q", "k", "v"):
        with pytest.raises(RuntimeError, match="use_flash=False"):
            A.flash_attention(tensors["q"], tensors["k"], tensors["v"])
    with torch.no_grad():
        out = A.flash_attention_2d_bias(*tensors.values(), 4, 4)
        out7 = A.flash_attention(tensors["q"], tensors["k"], tensors["v"])
    assert not out.requires_grad and not out7.requires_grad


def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    q, k, v, bh, bw = _qkv_bias(cuda_device, torch.float32, 1, 1, 4, 4, 64, 0)
    with pytest.raises(TypeError):
        A.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        A.flash_attention_2d_bias(q, k, v, bh.bfloat16(), bw, 4, 4)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_attention(q[..., :20].contiguous(), k[..., :20].contiguous(),
                          v[..., :20].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention(torch.cat([q, q], dim=-1)[..., ::2], k, v)
    q, k, v, bh, bw = _qkv_bias(cuda_device, torch.float32, 1, 1, 1, 1000,
                                64, 0)
    with pytest.raises(ValueError, match="shared memory"):
        A.flash_attention_2d_bias(q, k, v, bh, bw, 1, 1000)


@pytest.mark.parametrize("Q,N,D", [(16, 100_003, 512), (1, 129, 512),
                                   (40, 4096, 512), (3, 1000, 1040),
                                   (5, 77, 16)])
def test_scan_kernel_bit_exact_vs_plain(cuda_device, Q, N, D):
    g = torch.Generator(device="cpu").manual_seed(N)
    q = torch.randint(-127, 128, (Q, D), generator=g, dtype=torch.int8)
    rows = torch.randint(-127, 128, (N, D), generator=g, dtype=torch.int8)
    pen = torch.where(torch.rand(N, generator=g) < 0.1, -1e30, 0.0)
    q, rows, pen = q.to(cuda_device), rows.to(cuda_device), pen.to(cuda_device)
    before = S.KERNEL.launches
    got = S.int8_scan_scores(q, rows, pen)
    torch.cuda.synchronize()
    assert S.KERNEL.launches == before + 1
    torch.testing.assert_close(got, S.int8_scan_scores_plain(q, rows, pen),
                               atol=0, rtol=0)
    # The exact integer scores on the CPU agree too.
    cpu = S.int8_scan_scores(q.cpu(), rows.cpu(), pen.cpu())
    torch.testing.assert_close(got.cpu(), cpu, atol=0, rtol=0)


def test_scan_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(2, 24, dtype=torch.int8, device=cuda_device)
    rows = torch.zeros(8, 24, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        S.int8_scan_scores(q, rows, torch.zeros(8, device=cuda_device))
    rows = torch.zeros(8, 32, dtype=torch.int8, device=cuda_device)
    with pytest.raises(TypeError):
        S.int8_scan_scores(q[:, :16].contiguous().float(), rows[:, :16],
                           torch.zeros(8, device=cuda_device))


@pytest.mark.parametrize("Q,N,D", [(16, 100_003, 512), (1, 129, 512),
                                   (40, 4096, 512), (3, 1000, 1024),
                                   (5, 77, 32),
                                   # the 32-row group's edges, one row
                                   (17, 31, 64), (16, 32, 64), (16, 33, 64),
                                   (1, 1, 512),
                                   # dims that end inside a 64-byte chunk
                                   (16, 5000, 160), (7, 999, 96),
                                   # more groups than resident warps
                                   (16, 300_001, 64), (40, 70_001, 1024)])
def test_int4_scan_kernel_bit_exact_vs_plain(cuda_device, Q, N, D):
    """Every byte value, positive scales, 10% of rows masked, and query
    halves drawn apart so a lo/hi swap would show."""
    g = torch.Generator(device="cpu").manual_seed(N + D)
    q = torch.randint(-127, 128, (Q, D), generator=g, dtype=torch.int8)
    q[:, D // 2:] //= 3
    packed = torch.randint(-128, 128, (N, D // 2), generator=g,
                           dtype=torch.int8)
    scales = torch.rand(N, generator=g) * 0.2 + 1e-3
    pen = torch.where(torch.rand(N, generator=g) < 0.1, -1e30, 0.0)
    args = [t.to(cuda_device) for t in (q, packed, scales, pen)]
    before = S4.KERNEL.launches
    got = S4.int4_scan_scores(*args)
    torch.cuda.synchronize()
    assert S4.KERNEL.launches == before + 1
    torch.testing.assert_close(got, S4.int4_scan_scores_plain(*args),
                               atol=0, rtol=0)
    cpu = S4.int4_scan_scores(q, packed, scales, pen)
    torch.testing.assert_close(got.cpu(), cpu, atol=0, rtol=0)


def test_int4_scan_kernel_rejects_what_it_does_not_take(cuda_device):
    def z(*shape, dtype=torch.int8):
        return torch.zeros(*shape, dtype=dtype, device=cuda_device)

    with pytest.raises(ValueError, match="shape"):  # odd dim
        S4.int4_scan_scores(z(2, 33), z(8, 16), z(8, dtype=torch.float32),
                            z(8, dtype=torch.float32))
    with pytest.raises(ValueError, match="dim % 32"):
        S4.int4_scan_scores(z(2, 48), z(8, 24), z(8, dtype=torch.float32),
                            z(8, dtype=torch.float32))
    with pytest.raises(TypeError):
        S4.int4_scan_scores(z(2, 64), z(8, 32), z(8, dtype=torch.float64),
                            z(8, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        S4.int4_scan_scores(z(2, 64), z(32, 8).T, z(8, dtype=torch.float32),
                            z(8, dtype=torch.float32))


# Sums of up to N distances: the JAX package's medoid tolerance
# (tests/test_pallas_medoid.py), for the Gram trick summed in another order.
@pytest.mark.parametrize("N,D", [(12_000, 512), (1, 512), (65, 512),
                                 (1000, 36), (4097, 128),
                                 # the 128-row tile's edges
                                 (127, 512), (128, 512), (129, 512),
                                 (257, 64), (2, 4)])
def test_medoid_kernel_matches_plain(cuda_device, N, D):
    g = torch.Generator(device="cpu").manual_seed(N + D)
    x = torch.nn.functional.normalize(torch.randn(N, D, generator=g), dim=1)
    x = x.to(cuda_device)
    before = M.KERNEL.launches
    got = M.pairwise_distance_sums(x)
    torch.cuda.synchronize()
    assert M.KERNEL.launches == before + 1
    want = M.pairwise_distance_sums_plain(x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=5e-2)
    # Deterministic: no float atomics, so a second run is bit-identical.
    assert torch.equal(M.pairwise_distance_sums(x), got)
    i = M.medoid_index(got)
    assert i == M.medoid_index(want) or \
        abs(float(want[i] - want.min())) <= 5e-2 + 1e-4 * float(want.min())


@pytest.mark.parametrize("N", [600, 3000])
def test_medoid_kernel_near_duplicate_rows(cuda_device, N):
    """A class of jittered crops: one unit centre plus 1e-3 noise, 512-d, so
    d² is a difference of nearly equal numbers. Against float64 direct
    distances the kernel (3xTF32) is as close as the plain f32 version and
    within the medoid's tolerance, and its member is as good as the plain
    one's; one TF32 product would be off by more than the sums differ."""
    g = torch.Generator(device="cpu").manual_seed(N)
    centre = torch.nn.functional.normalize(
        torch.randn(512, generator=g, dtype=torch.float64), dim=0)
    x64 = (centre + 1e-3 * torch.randn(N, 512, generator=g,
                                       dtype=torch.float64)).float().double()
    ref = torch.cdist(x64.to(cuda_device), x64.to(cuda_device),
                      compute_mode="donot_use_mm_for_euclid_dist").sum(1)
    x = x64.float().to(cuda_device)
    got = M.pairwise_distance_sums(x)
    torch.cuda.synchronize()
    plain = M.pairwise_distance_sums_plain(x)
    tol = 5e-2 + 1e-4 * float(ref.min())
    err = float((got.double() - ref).abs().max())
    err_plain = float((plain.double() - ref).abs().max())
    assert err <= tol and err <= 2 * err_plain + 1e-4 * float(ref.min())
    best = float(ref.min())
    assert float(ref[M.medoid_index(got)]) - best <= \
        float(ref[M.medoid_index(plain)]) - best + 1e-3
    assert torch.equal(M.pairwise_distance_sums(x), got)


@pytest.mark.parametrize("N,slots", [(1000, 3), (1000, 1), (4097, 5)])
def test_medoid_kernel_super_blocks(cuda_device, monkeypatch, N, slots):
    """A scratch budget of a few row tiles: the launcher walks super-blocks
    in one wrapper call, and the sums stay within the tolerance of the plain
    version and of the one-super-block run, bit-identical run to run."""
    g = torch.Generator(device="cpu").manual_seed(N)
    x = torch.nn.functional.normalize(torch.randn(N, 64, generator=g), dim=1)
    x = x.to(cuda_device)
    whole = M.pairwise_distance_sums(x)
    monkeypatch.setattr(M, "_SCRATCH_BYTES", slots * 4 * N)
    before = M.KERNEL.launches
    got = M.pairwise_distance_sums(x)
    torch.cuda.synchronize()
    assert M.KERNEL.launches == before + 1
    torch.testing.assert_close(got, M.pairwise_distance_sums_plain(x),
                               rtol=1e-4, atol=5e-2)
    torch.testing.assert_close(got, whole, rtol=1e-5, atol=1e-3)
    assert torch.equal(M.pairwise_distance_sums(x), got)


def test_medoid_kernel_self_distance_is_zero(cuda_device):
    x = torch.tensor([[12.25, -31.5, 3.0, 0.5]], device=cuda_device)
    assert M.pairwise_distance_sums(x).item() == 0.0


def test_medoid_kernel_rejects_what_it_does_not_take(cuda_device):
    with pytest.raises(TypeError):
        M.pairwise_distance_sums(torch.zeros(8, 16, dtype=torch.float64,
                                             device=cuda_device))
    with pytest.raises(ValueError, match="dim % 4"):
        M.pairwise_distance_sums(torch.zeros(8, 6, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        M.pairwise_distance_sums(torch.zeros(16, 8, device=cuda_device).T)
