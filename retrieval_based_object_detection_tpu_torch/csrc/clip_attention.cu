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
// 3.35 TB/s; its 0.5 GFLOP are negligible. The backward reads qkv and dO and
// writes dqkv, 34.4 MB (about 10 us), for about 1.2 GFLOP. Launch count and
// occupancy, not arithmetic, set their time.
//
// Forward design: one thread block per (image, head), so batch 64 gives 768
// blocks. The block loads the head's three T x D slices into shared memory as
// f32 (row stride D + 1, so column reads are free of bank conflicts), forms
// the T x T logits in f32 and applies the scale after the dot as the Pallas
// kernel does, runs each row's softmax in one warp with the lanes past T
// masked, rounds p to the input type, accumulates p v in f32 and casts once
// to the output type. T = 50 is never padded in device memory: every loop is
// bounded by T itself. Numbers kept in f32 are the Pallas kernel's: products
// of bf16 values are exact in f32, so the f32 FMA chain is its f32-accumulated
// dot.
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

namespace {

constexpr int kThreads = 128;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attn_core_fwd(const T* __restrict__ qkv, T* __restrict__ out, int seq,
                  int heads, int head_dim, float scale) {
  extern __shared__ float smem[];
  const int ld = head_dim + 1;  // padded stride of the q, k, v rows
  const int lp = seq + 1;       // padded stride of the logit rows
  float* qs = smem;
  float* ks = qs + seq * ld;
  float* vs = ks + seq * ld;
  float* ps = vs + seq * ld;  // [seq, lp]: logits, then probabilities

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int width = heads * head_dim;
  const T* src = qkv + (size_t)b * seq * 3 * width + h * head_dim;

  // Neighbouring threads read neighbouring d of one token: coalesced.
  for (int i = threadIdx.x; i < seq * head_dim; i += blockDim.x) {
    const int t = i / head_dim, d = i % head_dim;
    const T* row = src + (size_t)t * 3 * width + d;
    qs[t * ld + d] = to_float(row[0]);
    ks[t * ld + d] = to_float(row[width]);
    vs[t * ld + d] = to_float(row[2 * width]);
  }
  __syncthreads();

  // logits[r, c] = (q_r . k_c) * scale, f32 accumulation.
  for (int i = threadIdx.x; i < seq * seq; i += blockDim.x) {
    const int r = i / seq, c = i % seq;
    const float* q = qs + r * ld;
    const float* k = ks + c * ld;
    float acc = 0.f;
    for (int d = 0; d < head_dim; ++d) acc = fmaf(q[d], k[d], acc);
    ps[r * lp + c] = acc * scale;
  }
  __syncthreads();

  // Row softmax, one warp per row; lanes at c >= seq take no part.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < seq; r += nwarps) {
    float* row = ps + r * lp;
    float m = -INFINITY;
    for (int c = lane; c < seq; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < seq; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
    s = warp_sum(s);
    // p is rounded to the input type before the PV product, as the
    // Pallas kernel casts p to v's dtype.
    for (int c = lane; c < seq; c += 32)
      row[c] = to_float(from_float<T>(row[c] / s));
  }
  __syncthreads();

  // out[b, t, h*D + d] = sum_j p[t, j] v[j, d]: neighbouring threads write
  // neighbouring d of the merged layout.
  T* dst = out + (size_t)b * seq * width + h * head_dim;
  for (int i = threadIdx.x; i < seq * head_dim; i += blockDim.x) {
    const int t = i / head_dim, d = i % head_dim;
    const float* p = ps + t * lp;
    float acc = 0.f;
    for (int j = 0; j < seq; ++j) acc = fmaf(p[j], vs[j * ld + d], acc);
    dst[(size_t)t * width + d] = from_float<T>(acc);
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

template <typename T>
int launch(const void* qkv, void* out, int batch, int seq, int heads,
           int head_dim, float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(3 * seq * (head_dim + 1) + seq * (seq + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_core_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_core_fwd<T><<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), seq, heads, head_dim,
      scale);
  return (int)cudaGetLastError();
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
