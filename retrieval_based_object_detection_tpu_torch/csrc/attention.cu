// Flash attention for Hopper (sm_90a) on the tensor cores, with or without
// SAM's decomposed relative-position bias: kernels B6 and B7.
//
// Replaces: the Pallas kernels `_flash2d_kernel` (launched by
// `flash_attention_2d_bias`, B6) and `_flash_kernel` (launched by
// `flash_attention`, B7) in retrieval_based_object_detection_tpu/ops/attention.py.
// For each group g = b * H + h of [G, T, Dh] q, k, v it computes
//   o = softmax(q k^T * Dh^-1/2 + bias) v,
//   bias(qi, kj) = bias_h[g, qi, kj / grid_w] + bias_w[g, qi, kj % grid_w]
// (B6; B7 has no bias) with an online softmax over key tiles, so the
// [T, T] logits never reach device memory.
//
// Bound on the H100: operations. SAM-B's global layers have T = 4096 and
// Dh = 64: 4 T^2 Dh = 4.3 GFLOP per (image, head), 51.5 GFLOP per image over
// 12 heads: 0.052 ms at bf16's 989 TFLOP/s, 0.31 ms at the 165 TFLOP/s that
// 3xTF32 leaves of TF32's 495 (three products for one), against about 75 MB
// of q, k, v, bias and output per image in f32 (0.02 ms). Windowed layers
// (T = 196) are 17x smaller and bound by their bytes. Times quoted in this
// file are for one H100 SXM 80 GB at its 700 W limit, at the shapes
// chip_smoke.py times (B6 [4, 12, 4096, 64], grid 64 x 64; B7 the same).
//
// Design: one block per (128 query rows in bf16, 64 in f32; group), 8 or 4
// warps; each warp owns 16 query rows and runs both products on the tensor
// cores with mma.sync.
// - bf16: mma.m16n8k16 (bf16 in, f32 accumulators). The warp's Q rows are
//   loaded once as A fragments into registers; K fragments come from shared
//   memory by ldmatrix, V fragments by ldmatrix.trans. Dh is zero-padded in
//   shared memory to a multiple of 16 (zeros leave every dot unchanged), and
//   only the 16-wide chunks that hold head dims are multiplied.
// - f32: 3xTF32 on mma.m16n8k8, which keeps f32 accuracy: each operand is
//   split into a tf32 hi and the f32 rest lo, and lo*hi + hi*lo + hi*hi is
//   accumulated (one TF32 product alone is ~1e-3 relative). ldmatrix is
//   b16-only, so f32 fragments are 8-byte shared-memory loads: the k8
//   chunk's columns t and t + 4 (t = lane % 4) hold head dims 2t and 2t + 1
//   of Q and K, and output tiles go in pairs so that V's two B values are
//   adjacent. Q stays in registers as f32 and is split at use. The f32
//   kernel is bound by its ALU work (splits, addresses), not the tensor
//   cores: the 8-byte loads and the cheap split took SAM-B's global B6 from
//   8.7 to 5.4 ms.
// - Softmax in registers, on the S accumulator fragments: scale, bias, keys
//   past T set to -inf; the row max over the quad of threads that share a
//   row (two shuffles); l and the O accumulator rescaled by
//   exp(m_prev - m_new), with the running max starting at -1e30 (the first
//   rescale is exactly 0, never a NaN); exponentials in base 2. P becomes the
//   A fragment of the PV product without shared memory: in bf16 the m16n8
//   accumulators of two adjacent key tiles are one k16 A fragment; in f32 an
//   m16n8 accumulator is one k8 A fragment once its keys are taken in the
//   order 2t, 2t + 1, which V's rows follow.
// - K/V tiles of 64 keys go into shared memory by cp.async (16-byte copies)
//   in two stages, so tile j + 1 loads while tile j computes. Rows are padded
//   against bank conflicts (k_stride, v_stride). Key rows past T and head
//   dims past Dh are zero-filled by cp.async's src-size 0: a masked p of 0
//   times uninitialised shared memory could be a NaN.
// - B6's bias: the block's rows of bias_h and bias_w are staged once in
//   shared memory by cp.async beside tile 0, at an odd row stride; per key
//   tile a 64-entry table of each key's (kh, grid_h + kw) is written beside
//   the K/V stage, so each logit costs two table-indexed loads and two adds,
//   and no division. In bf16 a tile that lies inside one grid row (grid_w =
//   64 at SAM-B's global shape) reads bias_h once per row instead.
// - p is rounded to v's type before the PV product (bf16), as the Pallas
//   kernel casts it; the running sum l adds the unrounded p. The output is
//   acc / l, cast once to q's type, staged through shared memory and stored
//   as 16-byte vectors. Any T is taken: query rows past T compute but are not
//   stored, and a warp whose 16 rows all lie past T skips the products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

// The block: one 16-row m-tile of queries per warp, kWarps warps sharing
// each K/V tile. bf16 takes 8 warps (128 rows): half the K/V copies per
// row, B6 at SAM-B's global shape 1.33 against 1.58 ms with 4; f32 takes 4
// (B7 3.86 against 4.65 ms with 8). Two m-tiles a warp instead (each K/V
// fragment feeding two products) measured slower in bf16 (B6 2.00 against
// 1.66 ms with 4 warps of one): 216 registers a thread.
template <typename T>
struct Block {
  static constexpr int kWarps = std::is_same<T, float>::value ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // query rows
};
constexpr int kBlockK = 64;       // keys per shared-memory tile
constexpr int kNT = kBlockK / 8;  // 8-key tiles of S per key tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory row strides, in elements. bf16: +8, so ldmatrix's 8 rows
// fall in distinct 16-byte bank groups. f32: K rows +8 and V rows +4, so
// the 8-byte fragment loads of a half-warp hit distinct banks.
__host__ __device__ constexpr int k_stride(int d) { return d + 8; }
template <typename T>
__host__ __device__ constexpr int v_stride(int d) {
  return d + (std::is_same<T, float>::value ? 4 : 8);
}

template <typename T, int kD, bool kBias>
__global__ void __launch_bounds__(Block<T>::kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ bias_h,
              const float* __restrict__ bias_w, T* __restrict__ out, int seq,
              int head_dim, int grid_h, int grid_w, float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kWarps = Block<T>::kWarps;
  constexpr int kThreads = Block<T>::kThreads;
  constexpr int kBlockQ = Block<T>::kRows;
  constexpr int kLdK = k_stride(kD);              // K row, elements
  constexpr int kLdV = v_stride<T>(kD);           // V row, elements
  constexpr int kTileK = kBlockK * kLdK;          // one K stage
  constexpr int kTileV = kBlockK * kLdV;          // one V stage
  constexpr int kDT = kD / 8;                     // 8-wide head-dim tiles
  constexpr int kCh = 16 / sizeof(T);             // elements per 16 bytes

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // [2][kBlockK][kLdK]
  T* vs = ks + 2 * kTileK;             // [2][kBlockK][kLdV]
  int2* ktab = reinterpret_cast<int2*>(vs + 2 * kTileV);  // [2][kBlockK]
  float* bs = reinterpret_cast<float*>(ktab + 2 * kBlockK);  // [kBlockQ][bld]
  const int nb = grid_h + grid_w;
  const int bld = nb | 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column group
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int r0 = q0 + warp * 16;  // the warp's first query row
  const bool active = r0 < seq;
  const size_t base = (size_t)g * seq * head_dim;
  const int ntiles = (seq + kBlockK - 1) / kBlockK;
  const int nk16 = (head_dim + 15) / 16;  // 16-wide head-dim chunks
  const int nd8 = head_dim / 8;           // 8-wide head-dim chunks

  // K/V tile `tile` into stage `stage` (and B6's key table), async.
  auto load_tile = [&](int tile, int stage) {
    const int k0 = tile * kBlockK;
    constexpr int kRowCh = kD / kCh;
    T* kd = ks + stage * kTileK;
    T* vd = vs + stage * kTileV;
    for (int i = threadIdx.x; i < kBlockK * kRowCh; i += kThreads) {
      const int j = i / kRowCh, c = (i % kRowCh) * kCh;
      const bool ok = k0 + j < seq && c < head_dim;
      const size_t off = ok ? base + (size_t)(k0 + j) * head_dim + c : 0;
      cp_async16(kd + j * kLdK + c, k + off, ok);
      cp_async16(vd + j * kLdV + c, v + off, ok);
    }
    if constexpr (kBias) {
      for (int c = threadIdx.x; c < kBlockK; c += kThreads) {
        const int kj = k0 + c;
        int2 e = make_int2(0, grid_h);  // a key past T: masked anyway
        if (kj < seq) {
          const int kh = kj / grid_w;
          e = make_int2(kh, grid_h + kj - kh * grid_w);
        }
        ktab[stage * kBlockK + c] = e;
      }
    }
  };

  // The block's bias rows (zero past T) join tile 0's copies.
  if constexpr (kBias) {
    for (int r = warp; r < kBlockQ; r += kWarps) {
      const bool ok = q0 + r < seq;
      const size_t row = ok ? (size_t)g * seq + q0 + r : 0;
      for (int j = lane; j < nb; j += 32)
        cp_async4(bs + r * bld + j,
                  j < grid_h ? bias_h + row * grid_h + j
                             : bias_w + row * grid_w + (j - grid_h),
                  ok);
    }
  }
  load_tile(0, 0);
  cp_async_commit();

  // The warp's Q rows r0 + gq and r0 + gq + 8 in A-fragment layout, zero
  // past T and past Dh. In f32 the k8 chunk's columns tq and tq + 4 hold
  // head dims 2tq and 2tq + 1 (any order of the dims gives the same dots),
  // so K's two B values are one 8-byte load.
  const int ra = r0 + gq, rb = ra + 8;
  uint32_t qa[kBf16 ? kD / 16 : 1][4];
  float qf[kBf16 ? 1 : kD / 8][4];
  if (active) {
    if constexpr (kBf16) {
      auto ld2 = [&](int r, int c) -> uint32_t {
        if (r >= seq || c >= head_dim) return 0u;
        return *reinterpret_cast<const uint32_t*>(
            q + base + (size_t)r * head_dim + c);
      };
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
        const int c = kc * 16 + 2 * tq;
        qa[kc][0] = ld2(ra, c);
        qa[kc][1] = ld2(rb, c);
        qa[kc][2] = ld2(ra, c + 8);
        qa[kc][3] = ld2(rb, c + 8);
      }
    } else {
      auto ld1 = [&](int r, int c) -> float {
        if (r >= seq || c >= head_dim) return 0.f;
        return static_cast<float>(q[base + (size_t)r * head_dim + c]);
      };
#pragma unroll
      for (int kc = 0; kc < kD / 8; ++kc) {
        const int c = kc * 8 + 2 * tq;
        qf[kc][0] = ld1(ra, c);
        qf[kc][1] = ld1(rb, c);
        qf[kc][2] = ld1(ra, c + 1);
        qf[kc][3] = ld1(rb, c + 1);
      }
    }
  }

  // Rows gq (index 0) and gq + 8 (index 1) of the warp's 16.
  float m[2] = {-1e30f, -1e30f};  // running max, base-2 units
  float l[2] = {0.f, 0.f};        // this thread's part of the running sum
  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  const float* brow[2] = {bs + (warp * 16 + gq) * bld,
                          bs + (warp * 16 + gq + 8) * bld};

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and the bias rows) visible to every warp

    if (active) {
      const int k0 = t * kBlockK;
      const T* kt = ks + stage * kTileK;
      const T* vt = vs + stage * kTileV;
      const int2* tab = ktab + stage * kBlockK;
      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;

      // S = Q K^T on the warp's 16 rows and the tile's 64 keys.
      if constexpr (kBf16) {
        const int mi = lane >> 3;
        const int krow = (lane & 7) + ((mi & 2) ? 8 : 0);
        const int kcol = (mi & 1) ? 8 : 0;
#pragma unroll
        for (int kc = 0; kc < kD / 16; ++kc) {
          if (kc < nk16) {
#pragma unroll
            for (int np = 0; np < kNT / 2; ++np) {
              uint32_t b[4];
              ldmatrix_x4(b, kt + (np * 16 + krow) * kLdK + kc * 16 + kcol);
              mma_bf16(s[2 * np], qa[kc], b[0], b[1]);
              mma_bf16(s[2 * np + 1], qa[kc], b[2], b[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kc = 0; kc < kD / 8; ++kc) {
          if (kc < nd8) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(qf[kc][i], ah[i], al[i]);
#pragma unroll
            for (int n = 0; n < kNT; ++n) {
              const float2 kv = *reinterpret_cast<const float2*>(
                  kt + (n * 8 + gq) * kLdK + kc * 8 + 2 * tq);
              mma_3xtf32(s[n], ah, al, kv.x, kv.y);
            }
          }
        }
      }

      // Scale, bias, mask; row max over the quad; online rescale. In bf16,
      // a tile inside one grid row (SAM-B's global layers: grid_w = 64)
      // has one kh and consecutive kw, so its bias_h term is one load per
      // row and its bias_w term is read without the key table (in f32 the
      // extra registers cost more than the loads save: 7.36 against 7.14 ms).
      float mx[2] = {-INFINITY, -INFINITY};
      int kw0 = 0;
      bool one_row = false;
      float bh_row[2] = {0.f, 0.f};
      if constexpr (kBias && kBf16) {
        kw0 = k0 % grid_w;
        one_row = kw0 + kBlockK <= grid_w;
        if (one_row) {
          const int kh = k0 / grid_w;
          bh_row[0] = brow[0][kh];
          bh_row[1] = brow[1][kh];
        }
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n * 8 + 2 * tq + j;
          int2 e = make_int2(0, grid_h + kw0 + c);
          if constexpr (kBias) {
            if (!one_row) e = tab[c];
          }
          const bool key_ok = k0 + c < seq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = s[n][2 * h + j] * scale;
            if constexpr (kBias) {
              x = x + (one_row ? bh_row[h] : brow[h][e.x]);
              x = x + brow[h][e.y];
            }
            x = key_ok ? x * kLog2e : -INFINITY;
            s[n][2 * h + j] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = fast_exp2(m[h] - m_new);
        m[h] = m_new;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[dt][0] *= corr[0];
        o[dt][1] *= corr[0];
        o[dt][2] *= corr[1];
        o[dt][3] *= corr[1];
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(s[n][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[n][e] = p;
        }
      }

      // O += P V.
      if constexpr (kBf16) {
        const int mi = lane >> 3;
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
              uint32_t b[4];
              ldmatrix_x4_trans(b, vt + (kc * 16 + vrow) * kLdV + dp * 16 +
                                       vcol);
              mma_bf16(o[2 * dp], a, b[0], b[1]);
              mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
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
              mma_3xtf32(o[2 * dp], ah, al, v0.x, v1.x);
              mma_3xtf32(o[2 * dp + 1], ah, al, v0.y, v1.y);
            }
          }
        }
      }
    }
    __syncthreads();  // stage t is consumed before it is loaded again
  }

  if (!active) return;
  // acc / l, staged through the (consumed) K stages as the warp's 16 rows,
  // then stored as 16-byte vectors.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float inv0 = 1.f / l[0], inv1 = 1.f / l[1];
  T* os = ks + warp * 16 * kLdK;
  if constexpr (kBf16) {
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      if (dt < nd8) {
        const int c = dt * 8 + 2 * tq;
        store2<T>(os + gq * kLdK + c, o[dt][0] * inv0, o[dt][1] * inv0);
        store2<T>(os + (gq + 8) * kLdK + c, o[dt][2] * inv1,
                  o[dt][3] * inv1);
      }
    }
  } else {
#pragma unroll
    for (int dp = 0; dp < kD / 16; ++dp) {
      if (dp < nk16) {
        const int c = dp * 16 + 4 * tq;
        *reinterpret_cast<float4*>(os + gq * kLdK + c) =
            make_float4(o[2 * dp][0] * inv0, o[2 * dp + 1][0] * inv0,
                        o[2 * dp][1] * inv0, o[2 * dp + 1][1] * inv0);
        *reinterpret_cast<float4*>(os + (gq + 8) * kLdK + c) =
            make_float4(o[2 * dp][2] * inv1, o[2 * dp + 1][2] * inv1,
                        o[2 * dp][3] * inv1, o[2 * dp + 1][3] * inv1);
      }
    }
  }
  __syncwarp();
  const int row_ch = head_dim / kCh;
  for (int i = lane; i < 16 * row_ch; i += 32) {
    const int r = i / row_ch, c = (i % row_ch) * kCh;
    if (r0 + r < seq)
      *reinterpret_cast<uint4*>(out + base + (size_t)(r0 + r) * head_dim + c) =
          *reinterpret_cast<const uint4*>(os + r * kLdK + c);
  }
}

template <typename T, int kD, bool kBias>
int launch(const void* q, const void* k, const void* v, const float* bias_h,
           const float* bias_w, void* out, int groups, int seq, int head_dim,
           int grid_h, int grid_w, float scale, cudaStream_t stream) {
  size_t smem = (size_t)2 * kBlockK * (k_stride(kD) + v_stride<T>(kD)) *
                sizeof(T);
  if constexpr (kBias)
    smem += 2 * kBlockK * sizeof(int2) +
            (size_t)Block<T>::kRows * ((grid_h + grid_w) | 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, kD, kBias>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + Block<T>::kRows - 1) / Block<T>::kRows, groups);
  flash_fwd<T, kD, kBias><<<grid, Block<T>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias_h, bias_w, static_cast<T*>(out), seq,
      head_dim, grid_h, grid_w, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool kBias>
int dispatch(const void* q, const void* k, const void* v, const float* bias_h,
             const float* bias_w, void* out, int groups, int seq,
             int head_dim, int grid_h, int grid_w, float scale,
             cudaStream_t stream) {
  if (head_dim <= 32)
    return launch<T, 32, kBias>(q, k, v, bias_h, bias_w, out, groups, seq,
                                head_dim, grid_h, grid_w, scale, stream);
  if (head_dim <= 64)
    return launch<T, 64, kBias>(q, k, v, bias_h, bias_w, out, groups, seq,
                                head_dim, grid_h, grid_w, scale, stream);
  if (head_dim <= 128)
    return launch<T, 128, kBias>(q, k, v, bias_h, bias_w, out, groups, seq,
                                 head_dim, grid_h, grid_w, scale, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool kBias>
int dispatch_dtype(const void* q, const void* k, const void* v,
                   const float* bias_h, const float* bias_w, void* out,
                   int groups, int seq, int head_dim, int grid_h, int grid_w,
                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, kBias>(q, k, v, bias_h, bias_w, out, groups, seq,
                                  head_dim, grid_h, grid_w, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, kBias>(q, k, v, bias_h, bias_w, out,
                                          groups, seq, head_dim, grid_h,
                                          grid_w, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, out: [groups, seq, head_dim], dtype 0 = float32, 1 = bfloat16.
// Returns a cudaError_t as int.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int groups, int seq, int head_dim,
                        float scale, int dtype, void* stream) {
  return dispatch_dtype<false>(q, k, v, nullptr, nullptr, out, groups, seq,
                               head_dim, 1, 0, scale, dtype, stream);
}

// As flash_attention_fwd, plus the f32 bias tables bias_h
// [groups, seq, grid_h] and bias_w [groups, seq, grid_w], seq = grid_h *
// grid_w (keys in row-major grid order).
int flash_attention_2d_bias_fwd(const void* q, const void* k, const void* v,
                                const void* bias_h, const void* bias_w,
                                void* out, int groups, int seq, int head_dim,
                                int grid_h, int grid_w, float scale,
                                int dtype, void* stream) {
  return dispatch_dtype<true>(q, k, v, static_cast<const float*>(bias_h),
                              static_cast<const float*>(bias_w), out, groups,
                              seq, head_dim, grid_h, grid_w, scale, dtype,
                              stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
