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
                                         (2, 77, 8, 64)])
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


def test_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    qkv = torch.zeros(2, 50, 3 * 64, device=cuda_device)
    with pytest.raises(TypeError):
        CA.clip_attention_core(qkv.half(), heads=1)
    with pytest.raises(ValueError, match="contiguous"):
        CA.clip_attention_core(qkv.transpose(0, 1), heads=1)
    with pytest.raises(ValueError, match="shared memory"):
        CA.clip_attention_core(torch.zeros(1, 400, 3 * 64,
                                           device=cuda_device), heads=1)


# B5 against the plain backward. f32: the JAX package's custom-VJP tolerance
# (tests/test_clip_fused_attention.py), for the same f32 sums in another
# order. bf16: both sides compute in f32 and round once at the store, so they
# differ by at most one bf16 ulp (2^-7 relative) where the f32 sums round to
# neighbouring values.
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-4, 1e-4),
                                             (torch.bfloat16, 1e-3, 2 ** -7)])
@pytest.mark.parametrize("B,T,heads,D", [(8, 50, 12, 64), (3, 17, 4, 32),
                                         (2, 77, 8, 64)])
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
    with pytest.raises(ValueError, match="shared memory"):
        CA.clip_attention_core_bwd(
            torch.zeros(1, 120, 3 * 64, device=cuda_device),
            torch.zeros(1, 120, 64, device=cuda_device), heads=1)


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
                                         (2, 1, 7, 9, 16), (1, 2, 14, 14, 96)])
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
                                     (1, 1, 4096, 128)])
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
                                   (5, 77, 32)])
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
                                 (1000, 36), (4097, 128)])
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
