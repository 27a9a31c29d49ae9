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
// (about 10 us), for about 1.7 GFLOP as it is done here. So both must keep
// many blocks' loads in flight and spend few instructions per byte. Measured
// on an H100 at that shape, forward: 15 us in bf16 and 30 us in f32 (the
// CUDA-core kernel this replaced: 108 and 129 us); backward: 34 us in bf16
// and 89 us in f32 (the CUDA-core kernel this replaced: 218 and 230 us).
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
// Backward design: the same block of 4 warps per (image, head), every product
// on the tensor cores, and no [T, T] matrix in shared memory.
// - q, k, v of the head and the head's g = dO slice go into shared memory
//   once, in the input type, by 16-byte cp.async, all four at the Q/K row
//   stride (+8 elements), zero past T and past D: 36 KB a block at ViT-B/32
//   in bf16 (the CUDA-core kernel this replaced widened them to f32 and kept
//   two [T, T + 1] buffers: 72 KB).
// - Two orientations, so that each transposed product takes its A operand
//   from accumulators. In orientation A a warp owns 16 query rows: s = q k^T
//   and dp = g v^T in accumulators, the row max m and row sum l as in the
//   forward, p = e / l in f32 (never rounded), delta = rowsum(dp p) by quad
//   shuffles, dl = p (dp - delta), then dq = dl k with dl's accumulators as
//   the A fragment. m, l and delta of every row go to a small shared array.
//   After one __syncthreads, in orientation B a warp owns 16 keys: s^T = k q^T
//   and dp^T = v g^T, 16 queries at a time, p^T and dl^T rebuilt from the
//   stored m, l, delta of each column's query by the same expression (keys
//   and queries past T give p = 0), then dv = p^T g and dk = dl^T q. Seven
//   products in place of five; the two extra ones cost less than a [T, T]
//   round trip through shared memory and its transposed fragment loads.
// - Arithmetic that keeps the f32 contract. bf16 inputs: s and dp have two
//   bf16 operands, one mma (products exact, f32 sums). p and dl are f32
//   values: each is split into bf16 hi = rn(x) and lo = rn(x - hi) and
//   multiplied by two mma (the dropped part is 2^-17 of the term, far under
//   the store's 2^-9); rounding p or dl to bf16 once would be another
//   function. f32 inputs: 3xTF32 with the running sum outside the tensor
//   core (mma_3xtf32_rn) for every product.
// - T <= 64 keeps the one key tile's s and dp in registers through the three
//   steps (m and l; delta; dl and dq); longer T forms them again per step.
// - dq goes from the accumulators straight into the q third of the packed
//   rows (its q and g rows are still operands of orientation B, so nothing
//   may be staged over them). dk and dv are staged in the warp's own k and v
//   rows, which no other warp reads after the barrier, and leave as 16-byte
//   vectors. Every (image, head) owns its slices: no atomics, the same bits
//   every run. Rows past T compute but are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kFwdWarps = 4;  // both kernels' block
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

// s[n] = the 16 rows at xt (A fragments) times the kN x 8 rows at yt (B
// fragments), summed over the head dims: s[n][0..1] are row gq, columns
// 8n + 2tq and + 1 of the 16 x 8kN product X Y^T, s[n][2..3] row gq + 8.
// Both arrays have rows of kLd elements. bf16: Q-like rows by ldmatrix as
// the A fragment, K-like rows by ldmatrix (kN even). f32: the k8 chunk's
// columns tq and tq + 4 hold head dims 2tq and 2tq + 1 of both operands (any
// order of the dims gives the same dots), so each fragment pair is one
// 8-byte load.
template <typename T, int kD, int kN>
__device__ __forceinline__ void dots_nt(float (&s)[kN][4], const T* xt,
                                        const T* yt, int nk16, int nd8,
                                        int lane) {
  constexpr int kLd = qk_stride(kD);
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
#pragma unroll
  for (int n = 0; n < kN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int arow = (lane & 7) + ((mi & 1) ? 8 : 0);
    const int acol = (mi & 2) ? 8 : 0;
    const int krow = (lane & 7) + ((mi & 2) ? 8 : 0);
    const int kcol = (mi & 1) ? 8 : 0;
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
      if (kc < nk16) {
        uint32_t a[4];
        ldmatrix_x4(a, xt + arow * kLd + kc * 16 + acol);
#pragma unroll
        for (int np = 0; np < kN / 2; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, yt + (np * 16 + krow) * kLd + kc * 16 + kcol);
          mma_bf16(s[2 * np], a, kb[0], kb[1]);
          mma_bf16(s[2 * np + 1], a, kb[2], kb[3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc) {
      if (kc < nd8) {
        const float2 qa = *reinterpret_cast<const float2*>(
            xt + gq * kLd + kc * 8 + 2 * tq);
        const float2 qb = *reinterpret_cast<const float2*>(
            xt + (gq + 8) * kLd + kc * 8 + 2 * tq);
        uint32_t ah[4], al[4];
        split_tf32(qa.x, ah[0], al[0]);
        split_tf32(qb.x, ah[1], al[1]);
        split_tf32(qa.y, ah[2], al[2]);
        split_tf32(qb.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(
              yt + (n * 8 + gq) * kLd + kc * 8 + 2 * tq);
          mma_3xtf32_rn(s[n], ah, al, kv.x, kv.y);
        }
      }
    }
  }
}

// o += P Y: P is the 16 x 8kN matrix that lies in the accumulators p (the
// layout dots_nt leaves), Y the 8kN rows at yt (rows of kLdY elements), so
// the accumulators are the A fragment and P never passes through shared
// memory. bf16: the accumulators of two adjacent 8-column tiles are one k16
// A fragment, Y by ldmatrix.trans; with kSplit each f32 value goes in as bf16
// hi + lo (two mma), without it rounded to bf16 once. f32 (3xTF32): columns
// in the order 2tq, 2tq + 1, and Y's rows read in the same order; output
// tiles go in pairs: column gq of tiles 2p and 2p + 1 is head dim 16p + 2gq
// and 16p + 2gq + 1, so their B values are one 8-byte load, and the thread's
// accumulators hold dims 16p + 4tq .. + 3.
template <typename T, int kD, int kLdY, int kN, bool kSplit>
__device__ __forceinline__ void acc_nn(float (&o)[kD / 8][4],
                                       const float (&p)[kN][4], const T* yt,
                                       int nk16, int lane) {
  const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int vrow = (lane & 7) + ((mi & 1) ? 8 : 0);
    const int vcol = (mi & 2) ? 8 : 0;
#pragma unroll
    for (int kc = 0; kc < kN / 2; ++kc) {
      uint32_t a[4], al[4];
      if constexpr (kSplit) {
        split_bf16(p[2 * kc][0], p[2 * kc][1], a[0], al[0]);
        split_bf16(p[2 * kc][2], p[2 * kc][3], a[1], al[1]);
        split_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1], a[2], al[2]);
        split_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3], a[3], al[3]);
      } else {
        a[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
        a[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
        a[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
        a[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        if (dp < nk16) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, yt + (kc * 16 + vrow) * kLdY + dp * 16 + vcol);
          if constexpr (kSplit) {
            mma_bf16(o[2 * dp], al, vb[0], vb[1]);
            mma_bf16(o[2 * dp + 1], al, vb[2], vb[3]);
          }
          mma_bf16(o[2 * dp], a, vb[0], vb[1]);
          mma_bf16(o[2 * dp + 1], a, vb[2], vb[3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      uint32_t ah[4], al[4];
      split_tf32(p[n][0], ah[0], al[0]);
      split_tf32(p[n][2], ah[1], al[1]);
      split_tf32(p[n][1], ah[2], al[2]);
      split_tf32(p[n][3], ah[3], al[3]);
      const float* yr = yt + (n * 8 + 2 * tq) * kLdY + 2 * gq;
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        if (dp < nk16) {
          const float2 v0 = *reinterpret_cast<const float2*>(yr + 16 * dp);
          const float2 v1 =
              *reinterpret_cast<const float2*>(yr + kLdY + 16 * dp);
          mma_3xtf32_rn(o[2 * dp], ah, al, v0.x, v1.x);
          mma_3xtf32_rn(o[2 * dp + 1], ah, al, v0.y, v1.y);
        }
      }
    }
  }
}

// The warp's 16 x D accumulators o (acc_nn's layout), times mul, into the 16
// rows of kLd elements at st.
template <typename T, int kD, int kLd>
__device__ __forceinline__ void stage_rows(T* st, const float (&o)[kD / 8][4],
                                           float mul, int nk16, int nd8,
                                           int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      if (dt < nd8) {
        const int c = dt * 8 + 2 * tq;
        store2<T>(st + gq * kLd + c, o[dt][0] * mul, o[dt][1] * mul);
        store2<T>(st + (gq + 8) * kLd + c, o[dt][2] * mul, o[dt][3] * mul);
      }
    }
  } else {
#pragma unroll
    for (int dp = 0; dp < kD / 16; ++dp) {
      if (dp < nk16) {
        const int c = dp * 16 + 4 * tq;
        *reinterpret_cast<float4*>(st + gq * kLd + c) =
            make_float4(o[2 * dp][0] * mul, o[2 * dp + 1][0] * mul,
                        o[2 * dp][1] * mul, o[2 * dp + 1][1] * mul);
        *reinterpret_cast<float4*>(st + (gq + 8) * kLd + c) =
            make_float4(o[2 * dp][2] * mul, o[2 * dp + 1][2] * mul,
                        o[2 * dp][3] * mul, o[2 * dp + 1][3] * mul);
      }
    }
  }
}

// The staged 16 rows at st, as 16-byte vectors, into rows r0 .. r0 + 15 of
// dst (row stride ld_dst elements); rows past seq are not stored.
template <typename T, int kLd>
__device__ __forceinline__ void copy_rows_out(T* dst, size_t ld_dst,
                                              const T* st, int r0, int seq,
                                              int head_dim, int lane) {
  constexpr int kCh = 16 / sizeof(T);
  const int row_ch = head_dim / kCh;
  for (int i = lane; i < 16 * row_ch; i += 32) {
    const int r = i / row_ch, c = (i % row_ch) * kCh;
    if (r0 + r < seq)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * ld_dst + c) =
          *reinterpret_cast<const uint4*>(st + r * kLd + c);
  }
}

// Keys (columns) k0 + 8n + 2tq + j at or past seq to -inf.
__device__ __forceinline__ void mask_keys(float (&s)[kNT][4], int k0, int seq,
                                          int tq) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (k0 + n * 8 + 2 * tq + j >= seq) s[n][j] = s[n][2 + j] = -INFINITY;
    }
  }
}

// One key tile's step of the softmax statistics: the running row max m (raw
// units) and row sum l of 2^((s - m) c2), for rows gq (index 0) and gq + 8
// (index 1) of the warp's 16; l is still to be summed over the quad. The
// running max starts at -1e30, so the first rescale is exactly 0, never a
// NaN.
__device__ __forceinline__ void row_stats_step(const float (&s)[kNT][4],
                                               float (&m)[2], float (&l)[2],
                                               float c2) {
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

// The sum of x over the quad of lanes that share a fragment row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s -> p = 2^((s - m) c2) / l in place.
__device__ __forceinline__ void probabilities(float (&s)[kNT][4],
                                              const float (&m)[2],
                                              const float (&l)[2], float c2) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = __fdiv_rn(fast_exp2((s[n][e] - m[e >> 1]) * c2), l[e >> 1]);
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(kFwdThreads)
    attn_core_fwd(const T* __restrict__ qkv, T* __restrict__ out, int seq,
                  int heads, int head_dim, float scale) {
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
  const int tq = lane & 3;  // the lane's column group in a fragment
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
  const int mtiles = (seq + 15) / 16;
  T* dst = out + (size_t)b * seq * width + h * head_dim;

  for (int mt = warp; mt < mtiles; mt += kFwdWarps) {
    const int r0 = mt * 16;
    T* qt = qs + r0 * kLdK;  // the warp's Q rows, later its output rows

    // s = the raw dots of the warp's 16 rows with the 64 keys of tile t;
    // keys past T at -inf.
    auto logits = [&](int t, float (&s)[kNT][4]) {
      dots_nt<T, kD, kNT>(s, qt, ks + t * kBlockK * kLdK, nk16, nd8, lane);
      mask_keys(s, t * kBlockK, seq, tq);
    };

    // Pass 1: the row max m and the row sum l over the key tiles.
    float s[kNT][4];
    float m[2] = {-1e30f, -1e30f};
    float l[2] = {0.f, 0.f};
    for (int t = 0; t < ntiles; ++t) {
      logits(t, s);
      row_stats_step(s, m, l, c2);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);

    // Pass 2: p = e / l, rounded to the input type, times V. One key tile:
    // s still holds its logits.
    float o[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      if (ntiles > 1) logits(t, s);
      probabilities(s, m, l, c2);
      acc_nn<T, kD, kLdV, kNT, false>(o, s, vs + t * kBlockK * kLdV, nk16,
                                      lane);
    }

    // The 16 x D outputs through the warp's own Q rows (no other warp reads
    // them), then 16-byte stores into the merged layout.
    __syncwarp();
    stage_rows<T, kD, kLdK>(qt, o, 1.f, nk16, nd8, lane);
    __syncwarp();
    copy_rows_out<T, kLdK>(dst, width, qt, r0, seq, head_dim, lane);
  }
}

// Blocks an SM that the backward's registers leave room for. f32 at head
// widths to 64 needs 175 registers unbounded, which fits two blocks where the
// shared memory (74 KB at T <= 64) fits three; held to three (170
// registers, no spills) it took 0.089 against 0.107 ms at [64, 50, 2304].
// bf16 (155 registers, three blocks) is slower when held to four.
template <typename T, int kD>
constexpr int kBwdBlocks = (std::is_same<T, float>::value && kD <= 64) ? 3 : 1;

template <typename T, int kD>
__global__ void __launch_bounds__(kFwdThreads, kBwdBlocks<T, kD>)
    attn_core_bwd(const T* __restrict__ qkv, const T* __restrict__ dout,
                  T* __restrict__ dqkv, int seq, int heads, int head_dim,
                  float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kLd = qk_stride(kD);  // rows of q, k, v and g, elements
  constexpr int kDT = kD / 8;
  constexpr int kCh = 16 / sizeof(T);
  constexpr int kRowCh = kD / kCh;

  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int ntiles = (seq + kBlockK - 1) / kBlockK;
  const int rows = ntiles * kBlockK;
  T* qs = reinterpret_cast<T*>(bwd_smem);  // [rows][kLd] each
  T* ks = qs + rows * kLd;
  T* vs = ks + rows * kLd;
  T* gs = vs + rows * kLd;
  float* st_m = reinterpret_cast<float*>(gs + rows * kLd);  // [rows] each
  float* st_l = st_m + rows;
  float* st_d = st_l + rows;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int width = heads * head_dim;
  const size_t row3 = (size_t)3 * width;
  const T* src = qkv + (size_t)b * seq * row3 + h * head_dim;
  const T* gsrc = dout + (size_t)b * seq * width + h * head_dim;

  // The head's q, k, v and g slices, zero past T and past D.
  for (int i = threadIdx.x; i < rows * kRowCh; i += kFwdThreads) {
    const int j = i / kRowCh, c = (i % kRowCh) * kCh;
    const bool ok = j < seq && c < head_dim;
    const T* p = src + (ok ? (size_t)j * row3 + c : 0);
    cp_async16(qs + j * kLd + c, p, ok);
    cp_async16(ks + j * kLd + c, p + width, ok);
    cp_async16(vs + j * kLd + c, p + 2 * width, ok);
    cp_async16(gs + j * kLd + c, gsrc + (ok ? (size_t)j * width + c : 0), ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int nk16 = (head_dim + 15) / 16;
  const int nd8 = head_dim / 8;
  const float c2 = scale * kLog2e;
  const int mtiles = (seq + 15) / 16;  // 16-row tiles of queries, and of keys
  T* dst = dqkv + (size_t)b * seq * row3 + h * head_dim;

  // Orientation A: the warp owns 16 query rows.
  for (int mt = warp; mt < mtiles; mt += kFwdWarps) {
    const int r0 = mt * 16;
    const T* qt = qs + r0 * kLd;
    const T* gt = gs + r0 * kLd;
    float s[kNT][4], dp[kNT][4];
    auto logits = [&](int t) {
      dots_nt<T, kD, kNT>(s, qt, ks + t * kBlockK * kLd, nk16, nd8, lane);
      mask_keys(s, t * kBlockK, seq, tq);
    };
    auto dprobs = [&](int t) {
      dots_nt<T, kD, kNT>(dp, gt, vs + t * kBlockK * kLd, nk16, nd8, lane);
    };

    // Step 1: m and l, as the forward takes them.
    float m[2] = {-1e30f, -1e30f};
    float l[2] = {0.f, 0.f};
    for (int t = 0; t < ntiles; ++t) {
      logits(t);
      row_stats_step(s, m, l, c2);
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);

    // Step 2: delta = rowsum(dp p). One key tile: s still holds its logits,
    // and p and dp stay in registers for step 3.
    float delta[2] = {0.f, 0.f};
    for (int t = 0; t < ntiles; ++t) {
      if (ntiles > 1) logits(t);
      probabilities(s, m, l, c2);
      dprobs(t);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          delta[e >> 1] = fmaf(dp[n][e], s[n][e], delta[e >> 1]);
      }
    }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);
    if (tq == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        st_m[r0 + gq + 8 * hh] = m[hh];
        st_l[r0 + gq + 8 * hh] = l[hh];
        st_d[r0 + gq + 8 * hh] = delta[hh];
      }
    }

    // Step 3: dl = p (dp - delta), dq = dl k.
    float o[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      if (ntiles > 1) {
        logits(t);
        probabilities(s, m, l, c2);
        dprobs(t);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] *= dp[n][e] - delta[e >> 1];
      }
      acc_nn<T, kD, kLd, kNT, true>(o, s, ks + t * kBlockK * kLd, nk16, lane);
    }

    // dq * scale from the accumulators into the q third: the warp's q and g
    // rows are still read by every warp in orientation B.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + gq + 8 * hh;
      if (r < seq) {
        T* row = dst + (size_t)r * row3;
        if constexpr (kBf16) {
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt) {
            if (dt < nd8)
              store2<T>(row + dt * 8 + 2 * tq, o[dt][2 * hh] * scale,
                        o[dt][2 * hh + 1] * scale);
          }
        } else {
#pragma unroll
          for (int p2 = 0; p2 < kD / 16; ++p2) {
            const int c = p2 * 16 + 4 * tq;
            if (c < head_dim)
              *reinterpret_cast<float4*>(row + c) = make_float4(
                  o[2 * p2][2 * hh] * scale, o[2 * p2 + 1][2 * hh] * scale,
                  o[2 * p2][2 * hh + 1] * scale,
                  o[2 * p2 + 1][2 * hh + 1] * scale);
          }
        }
      }
    }
  }
  __syncthreads();  // m, l, delta of every row; k and v no longer B operands

  // Orientation B: the warp owns 16 keys and walks the queries 16 at a time.
  for (int kt = warp; kt < mtiles; kt += kFwdWarps) {
    const int r0 = kt * 16;
    T* ka = ks + r0 * kLd;  // the warp's k and v rows, later dk and dv
    T* va = vs + r0 * kLd;
    float dk[kDT][4], dv[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
      dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
    }
    for (int qc = 0; qc < mtiles; ++qc) {
      const T* qt = qs + qc * 16 * kLd;
      const T* gt = gs + qc * 16 * kLd;
      float st[2][4], dpt[2][4];  // s^T then p^T; dp^T then dl^T
      dots_nt<T, kD, 2>(st, ka, qt, nk16, nd8, lane);
      dots_nt<T, kD, 2>(dpt, va, gt, nk16, nd8, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int j = qc * 16 + n * 8 + 2 * tq;  // the columns' queries
        const float2 mj = *reinterpret_cast<const float2*>(st_m + j);
        const float2 lj = *reinterpret_cast<const float2*>(st_l + j);
        const float2 dj = *reinterpret_cast<const float2*>(st_d + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          const bool ok = j + (e & 1) < seq && r0 + gq + 8 * (e >> 1) < seq;
          const float p = __fdiv_rn(
              fast_exp2((st[n][e] - (odd ? mj.y : mj.x)) * c2),
              odd ? lj.y : lj.x);
          st[n][e] = ok ? p : 0.f;
          dpt[n][e] = ok ? p * (dpt[n][e] - (odd ? dj.y : dj.x)) : 0.f;
        }
      }
      acc_nn<T, kD, kLd, 2, true>(dv, st, gt, nk16, lane);
      acc_nn<T, kD, kLd, 2, true>(dk, dpt, qt, nk16, lane);
    }

    // dk * scale and dv through the warp's own k and v rows (since the
    // barrier only this warp reads them), then 16-byte stores.
    __syncwarp();
    stage_rows<T, kD, kLd>(ka, dk, scale, nk16, nd8, lane);
    stage_rows<T, kD, kLd>(va, dv, 1.f, nk16, nd8, lane);
    __syncwarp();
    copy_rows_out<T, kLd>(dst + width, row3, ka, r0, seq, head_dim, lane);
    copy_rows_out<T, kLd>(dst + 2 * width, row3, va, r0, seq, head_dim, lane);
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

template <typename T, int kD>
int launch_bwd(const void* qkv, const void* dout, void* dqkv, int batch,
               int seq, int heads, int head_dim, float scale,
               cudaStream_t stream) {
  const int rows = (seq + kBlockK - 1) / kBlockK * kBlockK;
  const size_t smem = (size_t)rows * 4 * qk_stride(kD) * sizeof(T) +
                      (size_t)rows * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_bwd<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_core_bwd<T, kD><<<batch * heads, kFwdThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), seq, heads, head_dim, scale);
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
int launch_backward(const void* qkv, const void* dout, void* dqkv, int batch,
                    int seq, int heads, int head_dim, float scale,
                    cudaStream_t stream) {
  if (head_dim % 8 != 0 || head_dim > 128) return (int)cudaErrorInvalidValue;
  if (head_dim <= 32)
    return launch_bwd<T, 32>(qkv, dout, dqkv, batch, seq, heads, head_dim,
                             scale, stream);
  if (head_dim <= 64)
    return launch_bwd<T, 64>(qkv, dout, dqkv, batch, seq, heads, head_dim,
                             scale, stream);
  return launch_bwd<T, 128>(qkv, dout, dqkv, batch, seq, heads, head_dim,
                            scale, stream);
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
    return launch_backward<float>(qkv, dout, dqkv, batch, seq, heads,
                                  head_dim, scale, s);
  if (dtype == 1)
    return launch_backward<__nv_bfloat16>(qkv, dout, dqkv, batch, seq, heads,
                                          head_dim, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
