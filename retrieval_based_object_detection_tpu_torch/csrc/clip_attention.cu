// CLIP attention core for Hopper (sm_90a): forward (B1) and backward (B5).
//
// Replaces: the Pallas kernels `_attn_core_kernel` (launched by
// `_pallas_attn_fwd`) and `_attn_core_bwd_kernel` (launched by
// `_pallas_attn_bwd`, the backward of its `custom_vjp`) in
// retrieval_based_object_detection_tpu/ops/clip_attention.py.
// The forward computes softmax(q k^T * D^-1/2) v for each image b and head h,
// reading q, k and v straight from the packed [B, T, 3W] qkv that the input
// projection emits and writing the merged [B, T, W] output, so no head
// transpose passes through device memory. The backward takes the same qkv
// and the output gradient dO [B, T, W] and writes dqkv [B, T, 3W] in the
// packed layout; it saves nothing from the forward and rebuilds the
// probabilities (the flash trade the Pallas kernel makes).
//
// Bound on the H100: bytes. At ViT-B/32 (T = 50, H = 12, D = 64) and batch 64
// in bf16 a forward reads 14.7 MB of qkv and writes 4.9 MB, about 6 us at
// 3.35 TB/s; its 0.5 GFLOP are 0.5 us on the bf16 tensor cores and 3 us at
// 3xTF32's rate. The backward reads qkv and dO and writes dqkv, 34.4 MB
// (about 10 us), for about 1.2 GFLOP. So the forward must keep many blocks'
// loads in flight and spend few instructions per byte. Measured on an H100
// at that shape: 15 us in bf16 and 30 us in f32 (the CUDA-core kernel this
// replaced: 108 and 129 us).
//
// Forward design: one block of 4 warps per (image, head), both products on
// the tensor cores by mma.sync (the building blocks of mma.cuh, shared with
// the flash kernels in attention.cu).
// - The head's q, k and v slices go into shared memory once, in the input
//   type, by 16-byte cp.async straight from the packed rows (q at column
//   h D, k at W + h D, v at 2W + h D), at padded row strides (+8 elements;
//   f32 V rows +4) so ldmatrix and the 8-byte f32 fragment loads are free of
//   bank conflicts. Rows past T (up to the next multiple of 64) and head dims
//   past D are zero-filled by cp.async's src-size 0: a masked p of 0 times
//   uninitialised shared memory could be a NaN. 27 KB a block at ViT-B/32 in
//   bf16 (54 KB in f32), so every block of a batch of 64 is resident at once.
// - Each warp owns 16-row tiles of queries (tile w, w + 4, ...). bf16:
//   mma.m16n8k16, Q by ldmatrix as the A fragment, K by ldmatrix, V by
//   ldmatrix.trans. f32: 3xTF32 on mma.m16n8k8 (each operand split into a
//   tf32 hi and the f32 rest lo; lo hi + hi lo + hi hi keeps f32 accuracy),
//   fragments by 8-byte loads with the head dims taken in the order 2t,
//   2t + 1 and output columns in pairs, as in attention.cu. The three
//   products of a k8 step start from zero and are added to the running sum
//   by a round-to-nearest f32 add (mma_3xtf32_rn): the tensor core's own
//   accumulator truncates, which on the H100 left the result 2.5e-6 from
//   float64 where this form is 5e-7 away, closer than the plain version's
//   einsum.
// - Softmax in registers, in the Pallas kernel's order. The logits of a
//   64-key tile lie in the warp's accumulators as raw dots, keys past T at
//   -inf before the max. Pass 1 takes the row max and the row sum of
//   exp((s - m) scale) over the key tiles (over the quad of lanes that share
//   a row: two shuffles each). Pass 2 forms p = e / sum, rounds it to the
//   input type and multiplies it into V; the accumulators of two adjacent
//   8-key tiles are one k16 A fragment, so p never passes through shared
//   memory. With T <= 64 (ViT-B/32: 50) there is one key tile and pass 2
//   reuses pass 1's logits; longer T computes the tile's logits again, which
//   is cheap next to the loads, and keeps the order: p is normalised, then
//   rounded, then multiplied, and PV accumulates in f32 with one cast at the
//   store. The scale is applied to s - m (exact for close values), then one
//   ex2.approx.
// - The warp's 16 x D outputs are staged in its own (consumed) Q rows and
//   stored as 16-byte vectors into out[b, t, h D : (h + 1) D]; query rows
//   past T compute but are not stored. T is never padded in device memory.
//
// Backward design: the same block per (image, head). q, k, v and g = dO of
// the head are widened to f32 in shared memory (4 T (D+1) floats, 52 KB at
// T = 50), then p = softmax(q k^T * scale) and dp = g v^T are formed together
// in two [T, T + 1] f32 buffers (20 KB). One warp per row turns dp into
// dl = p (dp - rowsum(dp p)). The last pass gives, for each (t, d),
// dq = scale * dl[t, :] k[:, d], dk = scale * dl[:, t] q[:, d] and
// dv = p[:, t] g[:, d] (the transposed products read the [T, T] buffers by
// column), and writes the three into the q, k and v thirds of the packed row
// for head h. Every (image, head) owns its slices, so there are no atomics.
// As in the Pallas kernel everything stays f32 (p is not rounded) and the
// result is cast once, at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;  // the backward's block

constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kBlockK = 64;       // keys per tile of logits
constexpr int kNT = kBlockK / 8;  // 8-key tiles of S per key tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory row strides of the forward, in elements. Q and K rows +8:
// ldmatrix's 8 rows (bf16) and a half-warp's 8-byte loads (f32) fall in
// distinct banks. V rows +8 in bf16 and +4 in f32, where a half-warp reads
// two dims of eight keys.
__host__ __device__ constexpr int qk_stride(int d) { return d + 8; }
template <typename T>
__host__ __device__ constexpr int v_stride(int d) {
  return d + (std::is_same<T, float>::value ? 4 : 8);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int kD>
__global__ void __launch_bounds__(kFwdThreads)
    attn_core_fwd(const T* __restrict__ qkv, T* __restrict__ out, int seq,
                  int heads, int head_dim, float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kLdK = qk_stride(kD);    // Q and K rows, elements
  constexpr int kLdV = v_stride<T>(kD);  // V rows, elements
  constexpr int kDT = kD / 8;            // 8-wide head-dim tiles
  constexpr int kCh = 16 / sizeof(T);    // elements per 16 bytes
  constexpr int kRowCh = kD / kCh;

  extern __shared__ __align__(16) unsigned char fwd_smem[];
  const int ntiles = (seq + kBlockK - 1) / kBlockK;
  const int rows = ntiles * kBlockK;
  T* qs = reinterpret_cast<T*>(fwd_smem);  // [rows][kLdK]
  T* ks = qs + rows * kLdK;            // [rows][kLdK]
  T* vs = ks + rows * kLdK;            // [rows][kLdV]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column group
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int width = heads * head_dim;
  const size_t row3 = (size_t)3 * width;
  const T* src = qkv + (size_t)b * seq * row3 + h * head_dim;

  // The head's q, k, v slices, zero past T and past D. Neighbouring threads
  // copy neighbouring 16-byte chunks of one token's slice.
  for (int i = threadIdx.x; i < rows * kRowCh; i += kFwdThreads) {
    const int j = i / kRowCh, c = (i % kRowCh) * kCh;
    const bool ok = j < seq && c < head_dim;
    const T* p = src + (ok ? (size_t)j * row3 + c : 0);
    cp_async16(qs + j * kLdK + c, p, ok);
    cp_async16(ks + j * kLdK + c, p + width, ok);
    cp_async16(vs + j * kLdV + c, p + 2 * width, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int nk16 = (head_dim + 15) / 16;  // 16-wide head-dim chunks
  const int nd8 = head_dim / 8;           // 8-wide head-dim chunks
  const float c2 = scale * kLog2e;        // exp(x scale) = 2^(x c2)
  const int mi = lane >> 3;               // ldmatrix: this lane's 8x8 matrix
  const int mtiles = (seq + 15) / 16;
  T* dst = out + (size_t)b * seq * width + h * head_dim;

  for (int mt = warp; mt < mtiles; mt += kFwdWarps) {
    const int r0 = mt * 16;
    T* qt = qs + r0 * kLdK;  // the warp's Q rows, later its output rows

    // s = the raw dots of the warp's 16 rows with the 64 keys of tile t;
    // keys past T at -inf.
    auto logits = [&](int t, float (&s)[kNT][4]) {
      const T* kt = ks + t * kBlockK * kLdK;
#pragma unroll
      for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      if constexpr (kBf16) {
        const int arow = (lane & 7) + ((mi & 1) ? 8 : 0);
        const int acol = (mi & 2) ? 8 : 0;
        const int krow = (lane & 7) + ((mi & 2) ? 8 : 0);
        const int kcol = (mi & 1) ? 8 : 0;
#pragma unroll
        for (int kc = 0; kc < kD / 16; ++kc) {
          if (kc < nk16) {
            uint32_t a[4];
            ldmatrix_x4(a, qt + arow * kLdK + kc * 16 + acol);
#pragma unroll
            for (int np = 0; np < kNT / 2; ++np) {
              uint32_t kb[4];
              ldmatrix_x4(kb, kt + (np * 16 + krow) * kLdK + kc * 16 + kcol);
              mma_bf16(s[2 * np], a, kb[0], kb[1]);
              mma_bf16(s[2 * np + 1], a, kb[2], kb[3]);
            }
          }
        }
      } else {
        // The k8 chunk's columns tq and tq + 4 hold head dims 2tq and
        // 2tq + 1 of Q and K alike (any order of the dims gives the same
        // dots), so each fragment pair is one 8-byte load.
#pragma unroll
        for (int kc = 0; kc < kD / 8; ++kc) {
          if (kc < nd8) {
            const float2 qa = *reinterpret_cast<const float2*>(
                qt + gq * kLdK + kc * 8 + 2 * tq);
            const float2 qb = *reinterpret_cast<const float2*>(
                qt + (gq + 8) * kLdK + kc * 8 + 2 * tq);
            uint32_t ah[4], al[4];
            split_tf32(qa.x, ah[0], al[0]);
            split_tf32(qb.x, ah[1], al[1]);
            split_tf32(qa.y, ah[2], al[2]);
            split_tf32(qb.y, ah[3], al[3]);
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              const float2 kv = *reinterpret_cast<const float2*>(
                  kt + (n * 8 + gq) * kLdK + kc * 8 + 2 * tq);
              mma_3xtf32_rn(s[n], ah, al, kv.x, kv.y);
            }
          }
        }
      }
      const int k0 = t * kBlockK;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (k0 + n * 8 + 2 * tq + j >= seq)
            s[n][j] = s[n][2 + j] = -INFINITY;
        }
      }
    };

    // Pass 1: row max m (raw units) and row sum l of 2^((s - m) c2). Rows gq
    // (index 0) and gq + 8 (index 1) of the warp's 16. The running max
    // starts at -1e30, so the first rescale is exactly 0, never a NaN.
    float s[kNT][4];
    float m[2] = {-1e30f, -1e30f};
    float l[2] = {0.f, 0.f};
    for (int t = 0; t < ntiles; ++t) {
      logits(t, s);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh]);
        l[hh] *= fast_exp2((m[hh] - m_new) * c2);
        m[hh] = m_new;
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          l[e >> 1] += fast_exp2((s[n][e] - m[e >> 1]) * c2);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    }

    // Pass 2: p = e / l, rounded to the input type, times V. One key tile:
    // s still holds its logits.
    float o[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      if (ntiles > 1) logits(t, s);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = __fdiv_rn(fast_exp2((s[n][e] - m[e >> 1]) * c2),
                              l[e >> 1]);
      }
      const T* vt = vs + t * kBlockK * kLdV;
      if constexpr (kBf16) {
        const int vrow = (lane & 7) + ((mi & 1) ? 8 : 0);
        const int vcol = (mi & 2) ? 8 : 0;
#pragma unroll
        for (int kc = 0; kc < kNT / 2; ++kc) {
          const uint32_t a[4] = {
              pack_bf16(s[2 * kc][0], s[2 * kc][1]),
              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
          for (int dp = 0; dp < kD / 16; ++dp) {
            if (dp < nk16) {
              uint32_t vb[4];
              ldmatrix_x4_trans(vb, vt + (kc * 16 + vrow) * kLdV + dp * 16 +
                                        vcol);
              mma_bf16(o[2 * dp], a, vb[0], vb[1]);
              mma_bf16(o[2 * dp + 1], a, vb[2], vb[3]);
            }
          }
        }
      } else {
        // Keys in the order 2tq, 2tq + 1: the accumulator is the A
        // fragment, and V's rows are read in the same order. Output tiles
        // go in pairs: column gq of tiles 2p and 2p + 1 is head dim
        // 16p + 2gq and 16p + 2gq + 1, so their B values are one 8-byte
        // load, and the thread's accumulators hold dims 16p + 4tq .. + 3.
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          uint32_t ah[4], al[4];
          split_tf32(s[n][0], ah[0], al[0]);
          split_tf32(s[n][2], ah[1], al[1]);
          split_tf32(s[n][1], ah[2], al[2]);
          split_tf32(s[n][3], ah[3], al[3]);
          const float* vr = vt + (n * 8 + 2 * tq) * kLdV + 2 * gq;
#pragma unroll
          for (int dp = 0; dp < kD / 16; ++dp) {
            if (dp < nk16) {
              const float2 v0 = *reinterpret_cast<const float2*>(vr + 16 * dp);
              const float2 v1 =
                  *reinterpret_cast<const float2*>(vr + kLdV + 16 * dp);
              mma_3xtf32_rn(o[2 * dp], ah, al, v0.x, v1.x);
              mma_3xtf32_rn(o[2 * dp + 1], ah, al, v0.y, v1.y);
            }
          }
        }
      }
    }

    // The 16 x D outputs through the warp's own Q rows (no other warp reads
    // them), then 16-byte stores into the merged layout.
    __syncwarp();
    if constexpr (kBf16) {
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        if (dt < nd8) {
          const int c = dt * 8 + 2 * tq;
          store2<T>(qt + gq * kLdK + c, o[dt][0], o[dt][1]);
          store2<T>(qt + (gq + 8) * kLdK + c, o[dt][2], o[dt][3]);
        }
      }
    } else {
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        if (dp < nk16) {
          const int c = dp * 16 + 4 * tq;
          *reinterpret_cast<float4*>(qt + gq * kLdK + c) = make_float4(
              o[2 * dp][0], o[2 * dp + 1][0], o[2 * dp][1], o[2 * dp + 1][1]);
          *reinterpret_cast<float4*>(qt + (gq + 8) * kLdK + c) = make_float4(
              o[2 * dp][2], o[2 * dp + 1][2], o[2 * dp][3], o[2 * dp + 1][3]);
        }
      }
    }
    __syncwarp();
    const int row_ch = head_dim / kCh;
    for (int i = lane; i < 16 * row_ch; i += 32) {
      const int r = i / row_ch, c = (i % row_ch) * kCh;
      if (r0 + r < seq)
        *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * width + c) =
            *reinterpret_cast<const uint4*>(qt + r * kLdK + c);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_core_bwd(const T* __restrict__ qkv, const T* __restrict__ dout,
                  T* __restrict__ dqkv, int seq, int heads, int head_dim,
                  float scale) {
  extern __shared__ float smem[];
  const int ld = head_dim + 1;  // padded stride of the q, k, v, g rows
  const int lp = seq + 1;       // padded stride of the [T, T] rows
  float* qs = smem;
  float* ks = qs + seq * ld;
  float* vs = ks + seq * ld;
  float* gs = vs + seq * ld;
  float* ps = gs + seq * ld;  // [seq, lp]: logits, then probabilities
  float* ds = ps + seq * lp;  // [seq, lp]: dp, then dl

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int width = heads * head_dim;
  const size_t row3 = (size_t)3 * width;
  const T* src = qkv + (size_t)b * seq * row3 + h * head_dim;
  const T* gsrc = dout + (size_t)b * seq * width + h * head_dim;

  for (int i = threadIdx.x; i < seq * head_dim; i += blockDim.x) {
    const int t = i / head_dim, d = i % head_dim;
    const T* row = src + (size_t)t * row3 + d;
    qs[t * ld + d] = to_float(row[0]);
    ks[t * ld + d] = to_float(row[width]);
    vs[t * ld + d] = to_float(row[2 * width]);
    gs[t * ld + d] = to_float(gsrc[(size_t)t * width + d]);
  }
  __syncthreads();

  // logits[r, c] = (q_r . k_c) * scale and dp[r, c] = g_r . v_c.
  for (int i = threadIdx.x; i < seq * seq; i += blockDim.x) {
    const int r = i / seq, c = i % seq;
    const float* q = qs + r * ld;
    const float* k = ks + c * ld;
    const float* g = gs + r * ld;
    const float* v = vs + c * ld;
    float acc = 0.f, dacc = 0.f;
    for (int d = 0; d < head_dim; ++d) {
      acc = fmaf(q[d], k[d], acc);
      dacc = fmaf(g[d], v[d], dacc);
    }
    ps[r * lp + c] = acc * scale;
    ds[r * lp + c] = dacc;
  }
  __syncthreads();

  // Per row, one warp: p = softmax(logits), then dl = p (dp - sum(dp p)).
  // Each lane reads back only the columns it wrote itself.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < seq; r += nwarps) {
    float* prow = ps + r * lp;
    float* drow = ds + r * lp;
    float m = -INFINITY;
    for (int c = lane; c < seq; c += 32) m = fmaxf(m, prow[c]);
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < seq; c += 32) {
      const float e = expf(prow[c] - m);
      prow[c] = e;
      s += e;
    }
    s = warp_sum(s);
    float dot = 0.f;
    for (int c = lane; c < seq; c += 32) {
      const float p = prow[c] / s;
      prow[c] = p;
      dot = fmaf(drow[c], p, dot);
    }
    dot = warp_sum(dot);
    for (int c = lane; c < seq; c += 32) drow[c] = prow[c] * (drow[c] - dot);
  }
  __syncthreads();

  // dq[t, d] = scale * sum_j dl[t, j] k[j, d]
  // dk[t, d] = scale * sum_j dl[j, t] q[j, d]   (dl^T q: column t of dl)
  // dv[t, d] =         sum_j  p[j, t] g[j, d]   (p^T g:  column t of p)
  // Neighbouring threads write neighbouring d of head h's slice in each of
  // the q, k and v thirds of the packed row.
  T* dst = dqkv + (size_t)b * seq * row3 + h * head_dim;
  for (int i = threadIdx.x; i < seq * head_dim; i += blockDim.x) {
    const int t = i / head_dim, d = i % head_dim;
    float aq = 0.f, ak = 0.f, av = 0.f;
    for (int j = 0; j < seq; ++j) {
      aq = fmaf(ds[t * lp + j], ks[j * ld + d], aq);
      ak = fmaf(ds[j * lp + t], qs[j * ld + d], ak);
      av = fmaf(ps[j * lp + t], gs[j * ld + d], av);
    }
    T* row = dst + (size_t)t * row3 + d;
    row[0] = from_float<T>(aq * scale);
    row[width] = from_float<T>(ak * scale);
    row[2 * width] = from_float<T>(av);
  }
}

template <typename T, int kD>
int launch_fwd(const void* qkv, void* out, int batch, int seq, int heads,
               int head_dim, float scale, cudaStream_t stream) {
  const int rows = (seq + kBlockK - 1) / kBlockK * kBlockK;
  const size_t smem =
      (size_t)rows * (2 * qk_stride(kD) + v_stride<T>(kD)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_fwd<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_core_fwd<T, kD><<<batch * heads, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), seq, heads, head_dim,
      scale);
  return (int)cudaGetLastError();
}

// The instantiation for the head width: shared-memory rows and fragment
// loops are sized for 32, 64 or 128 dims, a narrower head is zero-padded.
template <typename T>
int launch(const void* qkv, void* out, int batch, int seq, int heads,
           int head_dim, float scale, cudaStream_t stream) {
  if (head_dim % 8 != 0 || head_dim > 128) return (int)cudaErrorInvalidValue;
  if (head_dim <= 32)
    return launch_fwd<T, 32>(qkv, out, batch, seq, heads, head_dim, scale,
                             stream);
  if (head_dim <= 64)
    return launch_fwd<T, 64>(qkv, out, batch, seq, heads, head_dim, scale,
                             stream);
  return launch_fwd<T, 128>(qkv, out, batch, seq, heads, head_dim, scale,
                            stream);
}

template <typename T>
int launch_bwd(const void* qkv, const void* dout, void* dqkv, int batch,
               int seq, int heads, int head_dim, float scale,
               cudaStream_t stream) {
  const size_t smem = (size_t)(4 * seq * (head_dim + 1) +
                               2 * seq * (seq + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_core_bwd<T><<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), seq, heads, head_dim, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
int clip_attention_fwd(const void* qkv, void* out, int batch, int seq,
                       int heads, int head_dim, float scale, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(qkv, out, batch, seq, heads, head_dim, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qkv, out, batch, seq, heads, head_dim, scale,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16; qkv, dout and dqkv share it. Returns a
// cudaError_t as int.
int clip_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                       int batch, int seq, int heads, int head_dim,
                       float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(qkv, dout, dqkv, batch, seq, heads, head_dim,
                             scale, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(qkv, dout, dqkv, batch, seq, heads,
                                     head_dim, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
