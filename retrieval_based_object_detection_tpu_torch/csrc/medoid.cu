// Blocked medoid distance sums for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_medoid_kernel`, launched by
// `pairwise_distance_sums` in retrieval_based_object_detection_tpu/ops/medoid.py.
// For [n, D] f32 rows x it computes sums[i] = sum_j sqrt(d2(i, j)) over the n
// rows, where d2 = max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0) by the Gram trick in
// f32 and d2(i, i) = 0 exactly (by the global row and column index). The n x n
// matrix never exists in device memory. n is taken as it is: the ragged last
// tile is masked here, where the Pallas kernel needed the rows padded to its
// block and a column mask.
//
// Bound on the H100: operations. At n = 12,000, D = 512 the Gram products are
// 2 n^2 D = 1.47e11 f32 FLOP, about 2.2 ms at 67 TFLOP/s outside the tensor
// cores; the 24.6 MB of rows take 7 us to read. TF32 tensor cores are not used:
// their 10-bit mantissa moves d2 of close members far more than the tolerance
// the medoid's argmin is held to.
//
// Design: a tiled f32 product on CUDA cores. A block of 256 threads owns a
// 64-row tile and walks a strided set of 64-column tiles. For each it stages
// the row and column panels, 32 dims deep, in shared memory (transposed, so a
// thread reads its 4 rows and its 4 columns as two 16-byte loads) and keeps a
// 4 x 4 tile of dot products in registers. The epilogue turns them into
// distances and adds them to 4 running row sums per thread. At the end the 16
// threads that share a row combine their sums with shuffles in a fixed order,
// and each block writes one partial per row: partial[segment, row]. A last
// kernel adds each row's partials in segment order. No float atomics: the
// sums, and so the argmin, are the same on every run. The row norms come from
// a small pre-pass, one warp per row.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // rows and columns of one distance tile
constexpr int kDepth = 32;     // dims per shared-memory panel
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 distances each

__global__ void row_norms(const float* __restrict__ x, float* __restrict__ sq,
                          int n, int dim) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;  // uniform across the warp
  const float* v = x + (size_t)row * dim;
  float s = 0.f;
  for (int d = lane; d < dim; d += 32) s = fmaf(v[d], v[d], s);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) sq[row] = s;
}

__global__ void __launch_bounds__(kThreads)
    tile_sums(const float* __restrict__ x, const float* __restrict__ sq,
              float* __restrict__ partial, int n, int dim, int col_tiles) {
  __shared__ __align__(16) float as[kDepth][kTile];  // row panel, k-major
  __shared__ __align__(16) float bs[kDepth][kTile];  // column panel
  const int tx = threadIdx.x % 16;  // this thread's columns: 4 tx .. 4 tx + 3
  const int ty = threadIdx.x / 16;  // this thread's rows: 4 ty .. 4 ty + 3
  const int row0 = blockIdx.y * kTile;
  float row_sum[4] = {0.f, 0.f, 0.f, 0.f};

  for (int t = blockIdx.x; t < col_tiles; t += gridDim.x) {
    const int col0 = t * kTile;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < dim; k0 += kDepth) {
      // 64 rows x 8 float4 per panel. Neighbouring threads take
      // neighbouring rows, so the transposed shared stores hit distinct
      // banks; each 32-byte sector a warp touches is finished by the
      // next pass's loads from L1.
      for (int i = threadIdx.x; i < kTile * kDepth / 4; i += kThreads) {
        const int m = i % kTile;
        const int k = (i / kTile) * 4;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 b = a;
        if (k0 + k < dim) {  // dim % 4 == 0: a float4 is all in or all out
          if (row0 + m < n)
            a = *reinterpret_cast<const float4*>(
                x + (size_t)(row0 + m) * dim + k0 + k);
          if (col0 + m < n)
            b = *reinterpret_cast<const float4*>(
                x + (size_t)(col0 + m) * dim + k0 + k);
        }
        as[k][m] = a.x; as[k + 1][m] = a.y; as[k + 2][m] = a.z;
        as[k + 3][m] = a.w;
        bs[k][m] = b.x; bs[k + 1][m] = b.y; bs[k + 2][m] = b.z;
        bs[k + 3][m] = b.w;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();  // panels read before the next pass overwrites them
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + tx * 4 + j;
        if (r < n && c < n) {
          float d2 = __fsub_rn(__fadd_rn(sq[r], sq[c]),
                               __fmul_rn(2.f, acc[i][j]));
          // Clamp before the root: the Gram trick can leave a tiny
          // negative. Self-distances are exactly 0 (by global index).
          d2 = r == c ? 0.f : fmaxf(d2, 0.f);
          row_sum[i] += sqrtf(d2);
        }
      }
    }
  }
  // The 16 threads of one row group are one half of a warp: combine their
  // sums in a fixed order.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = row_sum[i];
    for (int off = 8; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    const int r = row0 + ty * 4 + i;
    if (tx == 0 && r < n) partial[(size_t)blockIdx.x * n + r] = s;
  }
}

__global__ void add_partials(const float* __restrict__ partial,
                             float* __restrict__ sums, int n, int segments) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float s = 0.f;
  for (int g = 0; g < segments; ++g) s += partial[(size_t)g * n + r];
  sums[r] = s;
}

}  // namespace

extern "C" {

// x [n, dim] f32 (16-byte aligned, dim % 4 == 0); scratch sq [n] and
// partial [segments, n] f32; out sums [n] f32. segments <= ceil(n / 64).
// Returns a cudaError_t as int.
int medoid_sums(const void* x, void* sq, void* partial, void* sums, int n,
                int dim, int segments, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* sqf = static_cast<float*>(sq);
  float* pf = static_cast<float*>(partial);
  row_norms<<<(n + 7) / 8, 256, 0, s>>>(xf, sqf, n, dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kTile - 1) / kTile;
  tile_sums<<<dim3(segments, tiles), kThreads, 0, s>>>(xf, sqf, pf, n, dim,
                                                       tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  add_partials<<<(n + 255) / 256, 256, 0, s>>>(pf, static_cast<float*>(sums),
                                                n, segments);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
