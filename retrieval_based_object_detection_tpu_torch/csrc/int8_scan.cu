// int8 gallery scan for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_scan_kernel`, launched by `int8_scan_scores`
// in retrieval_based_object_detection_tpu/ops/int8_scan.py. It computes the
// [Q, N] f32 scores q_i8 . gallery_i8^T + penalty as exact integers: every
// dot is an int32 sum, and 127^2 * D < 2^24 (D <= 1040, checked by the
// wrapper) makes its conversion to f32 exact, so the scores are bit-identical
// to int8_cosine_topk's int32 scores. The Pallas kernel's bf16 detour, which
// works around a TPU codegen hang, has no counterpart here.
//
// Bound on the H100: bytes. At serving size (Q = 16, N = 1,048,576, D = 512)
// it must read the 512 MiB gallery once and write 64 MiB of scores, about
// 0.18 ms at 3.35 TB/s; its 17 G integer operations take 9 us at the int8
// tensor-core rate.
//
// Design: each block owns a tile of 128 gallery rows, one row per thread. The
// tile is copied into shared memory with 16-byte loads in which neighbouring
// threads read neighbouring bytes of the tile (coalesced); its row stride is
// padded by 16 bytes so that each thread's 16-byte reads of its own row are
// free of bank conflicts. The queries pass through shared memory 16 at a time
// (8 KB at D = 512), read as broadcasts. Each thread keeps 16 int32 sums in
// registers and forms them with __dp4a, converts them to f32, adds the row's
// penalty and writes them; neighbouring threads write neighbouring rows of one
// query, so the stores coalesce. The ragged last tile is masked, so N need not
// be a multiple of the tile.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 128;    // gallery rows per block, one per thread
constexpr int kQueries = 16;  // queries per pass, one accumulator each

__global__ void __launch_bounds__(kRows)
    scan(const int8_t* __restrict__ queries, const int8_t* __restrict__ rows,
         const float* __restrict__ penalty, float* __restrict__ out, int nq,
         int n, int dim) {
  extern __shared__ int4 smem[];
  const int chunks = dim / 16;  // 16-byte chunks per row
  const int ld = chunks + 1;    // padded tile stride, in chunks
  int4* tile = smem;            // [kRows, ld]
  int4* qs = tile + kRows * ld;  // [kQueries, chunks]

  const long long row0 = (long long)blockIdx.x * kRows;
  const int valid = (int)min((long long)kRows, (long long)n - row0);
  const int4* src = reinterpret_cast<const int4*>(rows + row0 * dim);
#pragma unroll 8
  for (int i = threadIdx.x; i < valid * chunks; i += kRows)
    tile[(i / chunks) * ld + i % chunks] = src[i];

  const int r = threadIdx.x;
  const bool live = r < valid;
  const float pen = live ? penalty[row0 + r] : 0.f;
  const int4 zero = make_int4(0, 0, 0, 0);

  for (int q0 = 0; q0 < nq; q0 += kQueries) {
    const int nqb = min(kQueries, nq - q0);
    __syncthreads();  // tile stored; the previous pass's queries are read
    const int4* qsrc = reinterpret_cast<const int4*>(queries + (size_t)q0 * dim);
    for (int i = threadIdx.x; i < kQueries * chunks; i += kRows)
      qs[i] = i < nqb * chunks ? qsrc[i] : zero;
    __syncthreads();
    if (!live) continue;

    int acc[kQueries];
#pragma unroll
    for (int j = 0; j < kQueries; ++j) acc[j] = 0;
    const int4* mine = tile + r * ld;
    for (int c = 0; c < chunks; ++c) {
      const int4 g = mine[c];
#pragma unroll
      for (int j = 0; j < kQueries; ++j) {
        const int4 q = qs[j * chunks + c];
        int a = __dp4a(g.x, q.x, acc[j]);
        a = __dp4a(g.y, q.y, a);
        a = __dp4a(g.z, q.z, a);
        acc[j] = __dp4a(g.w, q.w, a);
      }
    }
#pragma unroll
    for (int j = 0; j < kQueries; ++j)
      if (j < nqb)
        out[(size_t)(q0 + j) * n + row0 + r] = (float)acc[j] + pen;
  }
}

}  // namespace

extern "C" {

// queries [nq, dim] int8, rows [n, dim] int8 (16-byte aligned, dim % 16 == 0),
// penalty [n] f32, out [nq, n] f32. Returns a cudaError_t as int.
int int8_scan(const void* queries, const void* rows, const void* penalty,
              void* out, int nq, int n, int dim, void* stream) {
  const int chunks = dim / 16;
  const size_t smem =
      (size_t)(kRows * (chunks + 1) + kQueries * chunks) * sizeof(int4);
  cudaError_t err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  scan<<<blocks, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(queries), static_cast<const int8_t*>(rows),
      static_cast<const float*>(penalty), static_cast<float*>(out), nq, n,
      dim);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
