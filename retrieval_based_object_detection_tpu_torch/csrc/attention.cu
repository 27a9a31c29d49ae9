// Flash attention for Hopper (sm_90a), with or without SAM's decomposed
// relative-position bias: kernels B6 and B7.
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
// 12 heads, about 0.77 ms at the 67 TFLOP/s of f32 outside the tensor cores
// (0.052 ms at bf16's 989 TFLOP/s), against about 75 MB of q, k, v, bias
// and output per image (0.02 ms). Windowed layers (T = 196) are 17x smaller.
//
// Design, simple first (CUDA cores, no tensor cores, no TMA):
// - One block per (tile of 64 query rows, group). Each query row belongs to
//   kTpr adjacent threads (1, 2 or 4 for Dh up to 32, 64 or 128), each owning
//   32 of the head dims: its slice of q and of the f32 accumulator live in
//   registers. Dh is zero-padded to 32 * kTpr in registers and in shared
//   memory, which leaves every dot unchanged.
// - K and V tiles of 64 keys are staged in shared memory as f32 (bf16 is
//   widened on load); each key row is split into kTpr slices of 32 floats at
//   a stride of 36, so the kTpr threads of one row read distinct banks while
//   the rows of a warp read the same address (a broadcast).
// - Keys are taken 16 at a time: 16 partial dots in registers, summed across
//   the row's threads by shuffles, scaled, the bias added by indexing the
//   tables directly with the key's global grid position (one division per
//   16 keys, then a row-major step; no one-hot
//   expansion: the Pallas kernel's matmul stands in for gathers Mosaic
//   lacks), then one online-softmax update: running max from -1e30, the
//   running sum and the accumulator rescaled by exp(m_prev - m_new). Keys
//   past T get -inf before the max and add nothing to the sum.
// - The block's rows of the two bias tables ([64, grid_h + grid_w] f32, the
//   row stride made odd against bank conflicts) are staged once in shared
//   memory.
// - p is rounded to v's type before the PV product, as the Pallas kernel
//   casts it; the running sum adds the unrounded p. The output is acc / l,
//   cast once to q's type. Any T is taken: the ragged last tiles of queries
//   and keys are masked, never padded in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per online-softmax update
constexpr int kSlice = 32;    // head dims per thread
constexpr int kSliceLd = 36;  // padded stride of a slice in shared memory

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

template <typename T, int kTpr, bool kBias>
__global__ void __launch_bounds__(kBlockQ * kTpr)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ bias_h,
              const float* __restrict__ bias_w, T* __restrict__ out, int seq,
              int head_dim, int grid_h, int grid_w, float scale) {
  constexpr int kRowLd = kTpr * kSliceLd;  // one key row in shared memory
  constexpr int kWidth = kTpr * kSlice;    // padded head dim
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [kBlockK, kRowLd]
  float* vs = ks + kBlockK * kRowLd;  // [kBlockK, kRowLd]
  float* bs = vs + kBlockK * kRowLd;  // [kBlockQ, bld]: bias rows (B6 only)
  const int nb = grid_h + grid_w;
  const int bld = nb | 1;

  const int g = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int lr = threadIdx.x / kTpr;  // local query row
  const int sl = threadIdx.x % kTpr;  // head-dim slice of this thread
  const int qi = q0 + lr;
  const bool row_ok = qi < seq;
  const size_t base = (size_t)g * seq * head_dim;
  const int d0 = sl * kSlice;

  float qr[kSlice], acc[kSlice];
#pragma unroll
  for (int d = 0; d < kSlice; ++d) {
    const int dd = d0 + d;
    qr[d] = (row_ok && dd < head_dim)
                ? to_float(q[base + (size_t)qi * head_dim + dd])
                : 0.f;
    acc[d] = 0.f;
  }

  if (kBias) {
    for (int i = threadIdx.x; i < kBlockQ * nb; i += blockDim.x) {
      const int r = i / nb, j = i % nb;
      const size_t row = (size_t)g * seq + q0 + r;
      float b = 0.f;
      if (q0 + r < seq)
        b = j < grid_h ? bias_h[row * grid_h + j]
                       : bias_w[row * grid_w + (j - grid_h)];
      bs[r * bld + j] = b;
    }
  }
  const float* brow = bs + lr * bld;

  float m = -1e30f, l = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and the bias staged)
    for (int i = threadIdx.x; i < kBlockK * kWidth; i += blockDim.x) {
      const int j = i / kWidth, d = i % kWidth;
      float kv = 0.f, vv = 0.f;
      if (k0 + j < seq && d < head_dim) {
        const size_t off = base + (size_t)(k0 + j) * head_dim + d;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      const int at = j * kRowLd + (d / kSlice) * kSliceLd + d % kSlice;
      ks[at] = kv;
      vs[at] = vv;
    }
    __syncthreads();
    const int nk = min(kBlockK, seq - k0);

    for (int c0 = 0; c0 < nk; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = ks + (c0 + j) * kRowLd + sl * kSliceLd;
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < kSlice; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          a = fmaf(qr[d], k4.x, a);
          a = fmaf(qr[d + 1], k4.y, a);
          a = fmaf(qr[d + 2], k4.z, a);
          a = fmaf(qr[d + 3], k4.w, a);
        }
#pragma unroll
        for (int o = 1; o < kTpr; o <<= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        s[j] = a;
      }
      // Grid row and column of the chunk's first key, from its global
      // index; stepped along the chunk in row-major order.
      int kh = 0, kw = 0;
      if (kBias) {
        kh = (k0 + c0) / grid_w;
        kw = k0 + c0 - kh * grid_w;
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float x = -INFINITY;
        if (c0 + j < nk) {
          x = s[j] * scale;
          if (kBias) {
            x = x + brow[kh];
            x = x + brow[grid_h + kw];
          }
        }
        if (kBias && ++kw == grid_w) {
          kw = 0;
          ++kh;
        }
        s[j] = x;
        cmax = fmaxf(cmax, x);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = expf(s[j] - m_new);
        psum += p;
        s[j] = to_float(from_float<T>(p));
      }
      l = l * corr + psum;
#pragma unroll
      for (int d = 0; d < kSlice; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* vr = vs + (c0 + j) * kRowLd + sl * kSliceLd;
#pragma unroll
        for (int d = 0; d < kSlice; d += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
          acc[d] = fmaf(s[j], v4.x, acc[d]);
          acc[d + 1] = fmaf(s[j], v4.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[j], v4.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[j], v4.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    T* dst = out + base + (size_t)qi * head_dim;
#pragma unroll
    for (int d = 0; d < kSlice; ++d)
      if (d0 + d < head_dim) dst[d0 + d] = from_float<T>(acc[d] / l);
  }
}

template <typename T, int kTpr, bool kBias>
int launch(const void* q, const void* k, const void* v, const float* bias_h,
           const float* bias_w, void* out, int groups, int seq, int head_dim,
           int grid_h, int grid_w, float scale, cudaStream_t stream) {
  size_t smem = (size_t)2 * kBlockK * kTpr * kSliceLd * sizeof(float);
  if (kBias) smem += (size_t)kBlockQ * ((grid_h + grid_w) | 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, kTpr, kBias>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, groups);
  flash_fwd<T, kTpr, kBias><<<grid, kBlockQ * kTpr, smem, stream>>>(
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
    return launch<T, 1, kBias>(q, k, v, bias_h, bias_w, out, groups, seq,
                               head_dim, grid_h, grid_w, scale, stream);
  if (head_dim <= 64)
    return launch<T, 2, kBias>(q, k, v, bias_h, bias_w, out, groups, seq,
                               head_dim, grid_h, grid_w, scale, stream);
  if (head_dim <= 128)
    return launch<T, 4, kBias>(q, k, v, bias_h, bias_w, out, groups, seq,
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
