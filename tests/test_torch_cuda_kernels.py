"""The PyTorch port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc; without a GPU they skip. They
import neither JAX nor the JAX package, so on a machine that has only the
port's dependencies they run without the JAX test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import contextlib

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


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (a kernel on the card that is "
                    "not current)")
    return torch.device("cuda:0"), torch.device("cuda:1")


@pytest.mark.parametrize("kernel", ["B1", "B4", "B6"])
def test_kernel_launches_on_its_tensors_card(two_cards, kernel):
    """Each wrapper launches on its tensors' card and that card's stream,
    whichever card is current: B1, B4 and B6 on cuda:1 with cuda:0
    current, each against its plain version there."""
    current, other = two_cards
    g = torch.Generator(device="cpu").manual_seed(21)
    lib = {"B1": CA.KERNEL, "B4": M.KERNEL, "B6": A.KERNEL}[kernel]
    before = lib.launches
    with torch.cuda.device(current):
        if kernel == "B1":
            qkv = torch.randn(2, 50, 3 * 4 * 64, generator=g).to(
                other, torch.bfloat16)
            got = CA.clip_attention_core(qkv, heads=4)
            want = CA.clip_attention_core_plain(qkv, heads=4)
            tol = {"atol": 1e-2, "rtol": 2 ** -7}
        elif kernel == "B4":
            x = torch.nn.functional.normalize(
                torch.randn(1000, 64, generator=g), dim=1).to(other)
            got = M.pairwise_distance_sums(x)
            want = M.pairwise_distance_sums_plain(x)
            tol = {"rtol": 1e-4, "atol": 5e-2}
        else:
            q, k, v, bh, bw = _qkv_bias(other, torch.bfloat16, 2, 2, 9, 7,
                                        64, seed=21)
            got = A.flash_attention_2d_bias(q, k, v, bh, bw, 9, 7)
            want = A.flash_attention_2d_bias_plain(q, k, v, bh, bw, 9, 7)
            tol = {"atol": 1e-2, "rtol": 2 ** -7}
        torch.cuda.synchronize(other)
        assert torch.cuda.current_device() == current.index
    assert lib.launches == before + 1 and got.device == other
    torch.testing.assert_close(got.float(), want.float(), **tol)


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


def _int8_case(Q, N, D, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randint(-127, 128, (Q, D), generator=g, dtype=torch.int8)
    rows = torch.randint(-127, 128, (N, D), generator=g, dtype=torch.int8)
    pen = torch.where(torch.rand(N, generator=g) < 0.1, -1e30, 0.0)
    return q.to(device), rows.to(device), pen.to(device)


# The emulation's shapes (tests/test_torch_mma_emulation.py): passes over
# the queries, a ragged last group of 32 rows, dims that end inside a
# 64-byte chunk (16, 48, 1040) or take more than one step a tile.
@pytest.mark.parametrize("D", [16, 48, 512, 768, 1040])
@pytest.mark.parametrize("N", [1, 7, 8, 33, 4099])
@pytest.mark.parametrize("Q", [1, 5, 16, 17, 40])
def test_scan_kernel_ragged_shapes_bit_exact(cuda_device, Q, N, D):
    q, rows, pen = _int8_case(Q, N, D, cuda_device, Q * N + D)
    got = S.int8_scan_scores(q, rows, pen)
    torch.cuda.synchronize()
    assert torch.equal(got, S.int8_scan_scores_plain(q, rows, pen))


@pytest.mark.parametrize("N,D", [(40_953, 512), (1_001, 48), (40_960, 512)])
def test_scan_kernel_rows_at_the_end_of_an_allocation(cuda_device, N, D):
    """No load reads past the last row: the rows are the last bytes of a
    20 MiB segment that the caching allocator takes from cudaMalloc for
    this tensor alone (the cache emptied first), so a read past them would
    leave the allocation."""
    torch.cuda.empty_cache()
    size = 20 << 20
    buf = torch.empty(size, dtype=torch.int8, device=cuda_device)
    q, rows, pen = _int8_case(16, N, D, cuda_device, N + D)
    tail = buf[size - N * D:].view(N, D)
    tail.copy_(rows)
    got = S.int8_scan_scores(q, tail, pen)
    torch.cuda.synchronize()
    assert torch.equal(got, S.int8_scan_scores_plain(q, rows, pen))


def test_int_mm_agrees_with_the_plain_scan(cuda_device):
    """``torch._int_mm``, B2's yardstick in ``chip_smoke.py`` (cuBLASLt's
    int8 product, exact int32), gives the plain scan's scores bit for bit
    once transposed and added to the penalty."""
    q, rows, pen = _int8_case(16, 100_003, 512, cuda_device, 3)
    got = torch._int_mm(rows, q.t())
    assert got.dtype == torch.int32 and got.shape == (100_003, 16)
    assert torch.equal(got.t() + pen, S.int8_scan_scores_plain(q, rows, pen))


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


def test_int4_scan_kernel_past_2gib_of_packed_rows(cuda_device):
    """8,421,376 x 512: 2.16 GB of packed rows, past 2^31 bytes (the
    capacity tier's 10.5M rows are 2.7 GB). Bit for bit against the plain
    version on slices at the start, across the 2^31-byte line and at the
    end (the plain version of the whole would need 43 GB of float64)."""
    Q, N, D = 16, 8_421_376, 512
    g = torch.Generator(device=cuda_device).manual_seed(N)
    q = torch.randint(-127, 128, (Q, D), generator=g, dtype=torch.int8,
                      device=cuda_device)
    packed = torch.randint(-128, 128, (N, D // 2), generator=g,
                           dtype=torch.int8, device=cuda_device)
    scales = torch.rand(N, generator=g, device=cuda_device) * 0.2 + 1e-3
    pen = torch.where(torch.rand(N, generator=g, device=cuda_device) < 0.1,
                      -1e30, 0.0)
    got = S4.int4_scan_scores(q, packed, scales, pen)
    torch.cuda.synchronize()
    line = (1 << 31) // (D // 2)  # first row past 2^31 bytes
    for lo in (0, line - 32_768, N - 65_536):
        hi = lo + 65_536
        want = S4.int4_scan_scores_plain(q, packed[lo:hi], scales[lo:hi],
                                         pen[lo:hi])
        torch.testing.assert_close(got[:, lo:hi], want, atol=0, rtol=0)


def _unit_rows(n, d, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(n, d, generator=g).numpy()


def test_capacity_search_matches_its_plain_twin(cuda_device):
    """The capacity view on the card at 65,536 rows: its search launches
    B3 once and returns what the plain unpack-and-matmul twin returns over
    the same planes and masks."""
    from retrieval_based_object_detection_tpu_torch.gallery import (
        capacity, search,
    )

    n, d = 65_536, 512
    rows = _unit_rows(n, d, 1)
    live = torch.rand(n, generator=torch.Generator().manual_seed(2)).numpy()
    view = capacity.CapacitySearcher(rows, live > 0.05, headroom=4096,
                                     device=cuda_device)
    view.set_rows_invalid(range(0, n, 97))
    q = rows[:16] + 0.3 * _unit_rows(16, d, 3)
    before = S4.KERNEL.launches
    scores, idx = view.search(q, k=10)
    assert S4.KERNEL.launches == before + 1
    ts, ti = search.int4_cosine_topk(
        torch.from_numpy(q).to(cuda_device), view.dev_packed,
        view.dev_scales, view.dev_bf16, view.dev_mask, k=10, rescore=256)
    torch.testing.assert_close(torch.from_numpy(scores), ts.cpu(),
                               atol=1e-6, rtol=0)
    for a, b in zip(idx, ti.cpu().numpy()):
        assert set(a) == set(b)
    assert view._host_mask[idx].all()


def test_delete_reaches_each_scan_tier(cuda_device):
    """A delete by id and by filter on a CUDA gallery: every tier (exact,
    bf16, int8 through B2, int4 through B3, capacity through B3) drops the
    deleted rows at once, the mirrors are not rebuilt, and int8 keeps
    exact's top-10 set."""
    from retrieval_based_object_detection_tpu_torch.gallery import (
        schema, store,
    )

    n, d = 20_000, 512
    rows = _unit_rows(n, d, 4)
    g = store.Gallery("tomb", dim=d, device=cuda_device)
    g.upsert([f"p{i}" for i in range(n)], rows,
             [schema.Payload(data_type="original_images",
                             class_name=f"c{i % 50}") for i in range(n)])
    q = rows[:16] + 0.2 * _unit_rows(16, d, 5)
    tiers = ("exact", "bf16", "int8", "int4", "capacity")
    for t in tiers:
        g.search(q, k=10, method=t)
    mirrors = (g._dev_f32, g._dev_int8, g._dev_int4[0], g._cap.view)
    gone = {f"p{i}" for i in range(16)}
    assert g.delete(ids=sorted(gone)) == 16
    # c7 is every 50th row from p7, which the delete by id took already.
    assert g.delete(flt=schema.Filter(must={"class_name": "c7"})) == 399
    gone |= {f"p{i}" for i in range(7, n, 50)}
    b2, b3 = S.KERNEL.launches, S4.KERNEL.launches
    hits = {t: g.search(q, k=10, method=t) for t in tiers}
    assert S.KERNEL.launches == b2 + 1 and S4.KERNEL.launches == b3 + 2
    after = (g._dev_f32, g._dev_int8, g._dev_int4[0], g._cap.view)
    assert all(a is b for a, b in zip(after, mirrors))
    for t, res in hits.items():
        assert not gone & {h.id for r in res for h in r}, t
    for e, i8 in zip(hits["exact"], hits["int8"]):
        assert {h.id for h in e} == {h.id for h in i8}


@pytest.mark.parametrize("method", ["int8", "int4"])
def test_sharded_scan_four_shards_on_one_card(cuda_device, method):
    """A 4-shard sharded view on cuda:0 (the mesh lists the card four
    times), 600,000 rows, so each shard pads to a multiple of 8,192 rows:
    one search launches B2 or B3 once per shard, each shard's kernel
    scores equal its plain scan's bit for bit, and the merged top-10
    equals the merge of the plain twins' per-shard top-10."""
    from retrieval_based_object_detection_tpu_torch.gallery import (
        search, sharded,
    )
    from retrieval_based_object_detection_tpu_torch.parallel.mesh import (
        make_mesh,
    )

    n, d, k = 600_000, 512, 10
    rows = _unit_rows(n, d, 6)
    live = torch.rand(n, generator=torch.Generator().manual_seed(7)).numpy()
    mesh = make_mesh({"gallery": 4}, [cuda_device] * 4)
    view = sharded.ShardedGallerySearcher(rows, live > 0.1, mesh)
    assert view.rows_per == 155_648 and view.rows_per % 8192 == 0
    view.ensure_mirror(method)
    q = rows[:16] + 0.3 * _unit_rows(16, d, 8)
    kernel = S.KERNEL if method == "int8" else S4.KERNEL
    before = kernel.launches
    scores, idx = view.search(q, k=k, method=method)
    torch.cuda.synchronize()
    assert kernel.launches == before + 4
    qd = torch.from_numpy(q).to(cuda_device)
    q_i8 = search.quantize_rows_int8(search.l2_normalize(qd))
    rescore = min(max(8 * k, 256), view.rows_per)
    twin_s, twin_i = [], []
    for s in range(4):
        pen = torch.where(view.dev_mask[s], 0.0, search.NEG_INF).to(
            torch.float32)
        if method == "int8":
            got = S.int8_scan_scores(q_i8, view._dev_int8[s], pen)
            want = S.int8_scan_scores_plain(q_i8, view._dev_int8[s], pen)
            ts, ti = search.int8_cosine_topk(
                qd, view._dev_int8[s], view.dev_vectors[s], view.dev_mask[s],
                k=k, rescore=rescore)
        else:
            packed, scales = view._dev_int4[s]
            got = S4.int4_scan_scores(q_i8, packed, scales, pen)
            want = S4.int4_scan_scores_plain(q_i8, packed, scales, pen)
            ts, ti = search.int4_cosine_topk(
                qd, packed, scales, view.dev_vectors[s], view.dev_mask[s],
                k=k, rescore=rescore)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        twin_s.append(ts)
        twin_i.append(ti)
    ws, wi = sharded._gather_merge(twin_s, twin_i, view.rows_per, k)
    torch.testing.assert_close(torch.from_numpy(scores), ws.cpu(),
                               atol=1e-6, rtol=0)
    for a, b in zip(idx, wi.cpu().numpy()):
        assert set(a) == set(b)
    assert view._host_mask[idx].all()


@pytest.mark.parametrize("distance", ["dot", "euclid", "manhattan"])
def test_metric_topk_exact_on_the_card_vs_float64(cuda_device, distance):
    """``masked_metric_topk(exact=True)`` on CUDA multiplies in f32 with
    TF32 off (PyTorch's default, the rule of the exact cosine tier): its
    top-10 scores, and the float64 scores of the rows it returns, match a
    float64 reference to 1e-5 relative. One TF32 product would be ~1e-3."""
    from retrieval_based_object_detection_tpu_torch.gallery import search

    n, d, k = 50_000, 512, 10
    g = torch.Generator(device=cuda_device).manual_seed(7)
    rows = (torch.randn(n, d, generator=g, device=cuda_device)
            * (torch.rand(n, 1, generator=g, device=cuda_device) * 2.8 + 0.2))
    q = torch.randn(16, d, generator=g, device=cuda_device)
    mask = torch.rand(n, generator=g, device=cuda_device) > 0.2
    scores, idx = search.masked_metric_topk(q, rows, mask, k, distance)
    q64, r64 = q.double(), rows.double()
    if distance == "dot":
        ref = q64 @ r64.T
    elif distance == "euclid":
        ref = -torch.cdist(q64, r64)
    else:
        ref = -torch.cdist(q64, r64, p=1)
    ref = torch.where(mask[None], ref, -1e300)
    want, _ = torch.topk(ref, k, dim=1)
    torch.testing.assert_close(scores.double(), want, rtol=1e-5, atol=0)
    torch.testing.assert_close(torch.gather(ref, 1, idx), want, rtol=1e-5,
                               atol=0)


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


# --------------------------------------------- the front of the pipeline
# No TPU kernel is on this path: the detectors' convolutions are cuDNN's and
# the augment ops elementwise PyTorch. These hold the card's results to
# float64 and to the CPU at the tolerances ``chip_smoke.py`` states.
YOLO_TOL = {False: 1e-3, True: 3e-2}  # TF32 off / on, of the largest head


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """cuDNN's process-global TF32 flag, restored on exit."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("variant,size", [("tiny", 96), ("yolov8s", 640)])
@pytest.mark.parametrize("tf32", [False, True])
def test_yolo_heads_on_the_card_vs_float64(cuda_device, variant, size, tf32):
    from retrieval_based_object_detection_tpu_torch.models.yolo import (
        model as Y,
    )

    cfg = (Y.YoloConfig(0.33, 0.25, 1024, num_classes=7)
           if variant == "tiny" else Y.VARIANTS[variant])
    state = Y.params_from_jax(Y.init_params(cfg, seed=0))
    model = Y.build_model(state, cfg, device="cuda")
    ref = Y.build_model(state, cfg, device="cuda").double()
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, size, size, 3, generator=g).cuda()
    with cudnn_tf32(tf32):
        heads = Y.forward_features(model, x)
        boxes, probs = Y.predict(model, x)
    want = Y.forward_features(ref, x.double())
    wboxes, wprobs = Y.predict(ref, x.double())
    torch.cuda.synchronize()
    for h, w in zip(heads, want):
        err = float((h.double() - w).abs().max())
        assert err <= YOLO_TOL[tf32] * float(w.abs().max()), err
    assert float((boxes.double() - wboxes).abs().max()) <= \
        YOLO_TOL[tf32] * size
    assert float((probs.double() - wprobs).abs().max()) <= YOLO_TOL[tf32]


def test_augment_ops_on_the_card_equal_the_cpu(cuda_device):
    from retrieval_based_object_detection_tpu_torch.ops import image as I

    g = torch.Generator().manual_seed(2)
    x = torch.randint(0, 256, (83, 61, 4), generator=g).float()
    xc = x.cuda()
    for rate in I.BRIGHTNESS_RATES:
        assert torch.equal(I.brightness(xc, rate).cpu(), I.brightness(x, rate))
    for angle in I.ROTATION_ANGLES:
        assert torch.equal(I.rotate_expand(xc, float(angle)).cpu(),
                           I.rotate_expand(x, float(angle)))
    for radius in (2, 4, 6):
        assert torch.equal(I.gaussian_blur(xc, radius).cpu(),
                           I.gaussian_blur(x, radius))
    for level in I.NOISE_LEVELS:
        a = I.gaussian_noise(xc, level, torch.Generator().manual_seed(3))
        b = I.gaussian_noise(x, level, torch.Generator().manual_seed(3))
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
        a = I.salt_pepper(xc, level, torch.Generator().manual_seed(4))
        b = I.salt_pepper(x, level, torch.Generator().manual_seed(4))
        assert torch.equal(a.cpu(), b)


def test_tinydet_on_the_card_vs_the_cpu(cuda_device):
    """The forward to 1e-4 (f32 convs, TF32 off); the decoded scores to
    1e-4. Boxes are not compared slot by slot: near-equal scores may sort
    differently on the two devices."""
    from retrieval_based_object_detection_tpu_torch.models.detector import (
        tinydet as td,
    )

    cfg = td.TinyDetConfig()
    p = td.init_params(cfg, seed=0)
    g = torch.Generator().manual_seed(5)
    x = torch.rand(4, 256, 256, 3, generator=g) * 255
    pc, pp = td.params_from_jax(p, "cuda"), td.params_from_jax(p, "cpu")
    with cudnn_tf32(False):
        oc, lc = td.forward(pc, x.cuda(), cfg)
        _, sc = td.decode(pc, x.cuda(), cfg, conf_threshold=0.0)
    o, lt = td.forward(pp, x, cfg)
    _, s = td.decode(pp, x, cfg, conf_threshold=0.0)
    torch.testing.assert_close(oc.cpu(), o, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lc.cpu(), lt, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(sc.cpu(), s, rtol=0, atol=1e-4)


def test_fit_sam_step_on_the_card_vs_the_cpu(cuda_device):
    """One ``fit_sam`` step at ``SAM_TINY`` (the encoder on its einsum
    path, f32, TF32 off): the loss and metrics, and each gradient, at 1e-4
    of the CPU's (of each tensor's largest). The decoder's key biases have
    a true gradient of zero and are held at an absolute 1e-6."""
    import numpy as np

    from retrieval_based_object_detection_tpu_torch.models.sam import (
        model as SM,
    )
    from retrieval_based_object_detection_tpu_torch.train import (
        sam_loop as SL,
    )

    cfg, S = SM.SAM_TINY, SM.SAM_TINY.img_size
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (2, S, S, 3), dtype=np.uint8)
    masks = np.zeros((2, S, S), bool)
    masks[:, 24:96, 30:100] = True
    init = SM.init_params(cfg, seed=1)
    gt = SL._downsample_masks(masks, 4 * (S // cfg.encoder.patch_size))
    x = (images.astype(np.float32) - SM.SAM_MEAN) / SM.SAM_STD
    pts = np.full((2, 1, 2), (S / 2 + 0.5) / S, np.float32)
    inputs = [torch.from_numpy(a) for a in
              (x, pts, np.ones((2, 1), np.float32), gt)]
    loss_fn = SL.make_loss_fn(cfg, SL.SamFitConfig())
    out = {}
    with cudnn_tf32(False):
        for dev in ("cuda", "cpu"):
            params = SL._trainable(SM.params_from_jax(init, dev))
            total, met = loss_fn(params, *(t.to(dev) for t in inputs))
            total.backward()
            out[dev] = (total.item(), {k: float(v) for k, v in met.items()},
                        params)
        _, fit_met = SL.fit_sam(cfg, images, masks, cfg=SL.SamFitConfig(
            epochs=1, batch_size=2), params=init, device="cuda")
    (tc, mc, pc), (tp, mp, pp) = out["cuda"], out["cpu"]
    assert abs(tc - tp) <= 1e-4 * max(1.0, abs(tp))
    for k in mp:
        assert abs(mc[k] - mp[k]) <= 1e-4, (k, mc[k], mp[k])
        assert abs(fit_met[k] - mp[k]) <= 1e-4, (k, fit_met[k], mp[k])

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree

    cpu = dict(leaves(pp))
    for path, t in leaves(pc):
        g, w = t.grad.cpu(), cpu[path].grad
        tol = (1e-6 if path[0] == "decoder" and path[-2:] == ("k", "b")
               else 1e-4 * float(w.abs().max()))
        assert float((g - w).abs().max()) <= tol, path


def test_cli_platform_default_needs_a_card(monkeypatch):
    """Without ``--platform cpu`` the CLI runs on the card and raises when
    there is none; it never moves to the CPU on its own. Mocked, so it
    runs with or without a card."""
    from retrieval_based_object_detection_tpu_torch.cli import main as cli

    monkeypatch.delenv("RBOD_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["doctor"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--platform", "cuda", "store", "list"])


def test_cli_doctor_on_the_card(cuda_device, tmp_path, monkeypatch, capsys):
    """``doctor`` on the card: nvcc found, every kernel built, B1 against
    its plain version."""
    from retrieval_based_object_detection_tpu_torch.cli import main as cli

    monkeypatch.chdir(tmp_path)
    assert cli.main(["doctor"]) == 0
    out = capsys.readouterr().out
    assert "B1 kernel vs its plain version" in out
    assert "all checks passed" in out


@pytest.mark.parametrize("sizes", [{"dp": 2, "tp": 2}, {"dp": 4}],
                         ids=["dp2_tp2", "dp4"])
def test_mesh_step_gradients_on_the_card(cuda_device, sizes):
    """One f32 step on a mesh listing cuda:0 dp × tp times against the
    one-device step on the card (ViT-B/32 width, 2 blocks, batch 8): the
    loss to 1e-5 relative, each gradient tensor, its pieces joined, within
    1e-3 of its largest one-device entry (the row-parallel partial sums are
    added in another order). B1 and B5 launch once per dp shard and
    block."""
    import numpy as np

    from retrieval_based_object_detection_tpu_torch.models.clip import (
        model as clip_model,
    )
    from retrieval_based_object_detection_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from retrieval_based_object_detection_tpu_torch.train import train as T

    cfg = clip_model.CLIPVisionConfig(layers=2)
    tcfg = T.TrainConfig(num_classes=4, compute_dtype="float32")
    one, opt = T.init_state(cfg, tcfg, seed=0, device="cuda")
    n = int(np.prod(list(sizes.values())))
    model, _ = T.place(one, opt, make_mesh(sizes, ["cuda:0"] * n))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(8, 224, 224, 3)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 4, 8)).cuda()
    loss_one, _ = T.loss_fn(one, x, y, tcfg)
    loss_one.backward()
    fwd, bwd = (CA.KERNEL.counts[k] for k in ("clip_attention_fwd",
                                               "clip_attention_bwd"))
    loss, _ = T.loss_fn(model, x, y, tcfg)
    loss.backward()
    torch.cuda.synchronize()
    assert CA.KERNEL.counts["clip_attention_fwd"] - fwd == sizes["dp"] * 2
    assert CA.KERNEL.counts["clip_attention_bwd"] - bwd == sizes["dp"] * 2
    assert abs(loss.item() - loss_one.item()) <= 1e-5 * abs(loss_one.item())
    for p, (pieces, sh) in zip(one.parameters(), T.pieces(model)):
        g = sh.join([q.grad for q in pieces])
        assert float((g - p.grad).abs().max()) <= \
            1e-3 * float(p.grad.abs().max()), p.shape
