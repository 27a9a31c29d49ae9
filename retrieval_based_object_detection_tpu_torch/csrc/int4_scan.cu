// int4-packed gallery scan for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_scan_kernel`, launched by `int4_scan_scores`
// in retrieval_based_object_detection_tpu/ops/int4_scan.py. It computes the
// [Q, N] f32 scores float(sum_d q_i8[q, d] * w[n, d]) * scale[n] + penalty[n].
// Row n is packed two dims per byte by pack_rows_int4: byte packed[n, d] =
// 16 * hi + lo + 8 holds w[n, d] = lo and w[n, d + D/2] = hi, so the two
// unpacked planes face the two contiguous halves of each query. The integer
// dot is exact (|sum| <= 127 * 8 * D < 2^24, checked by the wrapper), and the
// multiply by the scale and the add of the penalty are rounded one at a time,
// as the plain version rounds them, so the scores agree bit for bit. The
// Pallas kernel's bias algebra, which moves the low-nibble unpack onto the
// TPU's matrix unit, has no counterpart here: the nibbles are unpacked with
// shifts and masks, four bytes at a time.
//
// Bound on the H100: bytes. At serving size (Q = 16, N = 1,048,576, D = 512)
// it must read the 256 MiB of packed rows and 8 MiB of scales and penalties
// once and write 64 MiB of scores, about 0.10 ms at 3.35 TB/s; its 17 G
// integer operations take 9 us at the int8 tensor-core rate. It issues as
// many __dp4a as the int8 scan (kernel B2), so it is not expected to run at
// half B2's time.
//
// Design: B2's, on packed rows. Each block owns a tile of 128 rows, one row
// per thread. The packed tile is copied into shared memory with 16-byte loads
// in which neighbouring threads read neighbouring bytes (coalesced), its row
// stride padded by 16 bytes so each thread's reads of its own row are free of
// bank conflicts. The queries pass through shared memory 16 at a time. Each
// thread unpacks a 16-byte chunk of its row once into 4 + 4 words of signed
// bytes (32 dims) and runs them against all 16 queries with __dp4a, so the
// unpack is shared by the queries of a pass. 16 int32 sums per thread live in
// registers; neighbouring threads write neighbouring rows of one query, so
// the stores coalesce. The ragged last tile is masked, so N need not be a
// multiple of the tile.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 128;    // rows per block, one per thread
constexpr int kQueries = 16;  // queries per pass, one accumulator each

// x - 8 in each of four bytes that hold 0..15: setting each byte's top bit
// first keeps the subtraction from borrowing across bytes, and the xor then
// restores the right top bit, giving the two's complement byte.
__device__ __forceinline__ int sub8(unsigned x) {
  return (int)(((x | 0x80808080u) - 0x08080808u) ^ 0x80808080u);
}

// lo = (b & 15) - 8 in each byte.
__device__ __forceinline__ int low_nibbles(int w) {
  return sub8((unsigned)w & 0x0F0F0F0Fu);
}

// hi = b >> 4 with the sign (floor(b / 16)) in each byte: the top nibble u is
// hi mod 16, and (u ^ 8) - 8 sign-extends it.
__device__ __forceinline__ int high_nibbles(int w) {
  return sub8((((unsigned)w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u);
}

__global__ void __launch_bounds__(kRows)
    scan(const int8_t* __restrict__ queries, const int8_t* __restrict__ packed,
         const float* __restrict__ scales, const float* __restrict__ penalty,
         float* __restrict__ out, int nq, int n, int dim) {
  extern __shared__ int4 smem[];
  const int chunks = dim / 32;   // 16-byte chunks per packed row
  const int ld = chunks + 1;     // padded tile stride, in chunks
  const int qchunks = dim / 16;  // 16-byte chunks per query
  int4* tile = smem;             // [kRows, ld]
  int4* qs = tile + kRows * ld;  // [kQueries, qchunks]

  const long long row0 = (long long)blockIdx.x * kRows;
  const int valid = (int)min((long long)kRows, (long long)n - row0);
  const int4* src = reinterpret_cast<const int4*>(packed + row0 * (dim / 2));
#pragma unroll 4
  for (int i = threadIdx.x; i < valid * chunks; i += kRows)
    tile[(i / chunks) * ld + i % chunks] = src[i];

  const int r = threadIdx.x;
  const bool live = r < valid;
  const float scale = live ? scales[row0 + r] : 0.f;
  const float pen = live ? penalty[row0 + r] : 0.f;
  const int4 zero = make_int4(0, 0, 0, 0);

  for (int q0 = 0; q0 < nq; q0 += kQueries) {
    const int nqb = min(kQueries, nq - q0);
    __syncthreads();  // tile stored; the previous pass's queries are read
    const int4* qsrc =
        reinterpret_cast<const int4*>(queries + (size_t)q0 * dim);
    for (int i = threadIdx.x; i < kQueries * qchunks; i += kRows)
      qs[i] = i < nqb * qchunks ? qsrc[i] : zero;
    __syncthreads();
    if (!live) continue;

    int acc[kQueries];
#pragma unroll
    for (int j = 0; j < kQueries; ++j) acc[j] = 0;
    const int4* mine = tile + r * ld;
    for (int c = 0; c < chunks; ++c) {
      const int4 b = mine[c];
      // Dims 16c .. 16c+15 (low nibbles) and D/2 + 16c .. (high nibbles).
      const int l0 = low_nibbles(b.x), l1 = low_nibbles(b.y);
      const int l2 = low_nibbles(b.z), l3 = low_nibbles(b.w);
      const int h0 = high_nibbles(b.x), h1 = high_nibbles(b.y);
      const int h2 = high_nibbles(b.z), h3 = high_nibbles(b.w);
#pragma unroll
      for (int j = 0; j < kQueries; ++j) {
        const int4 ql = qs[j * qchunks + c];
        const int4 qh = qs[j * qchunks + chunks + c];
        int a = __dp4a(l0, ql.x, acc[j]);
        a = __dp4a(l1, ql.y, a);
        a = __dp4a(l2, ql.z, a);
        a = __dp4a(l3, ql.w, a);
        a = __dp4a(h0, qh.x, a);
        a = __dp4a(h1, qh.y, a);
        a = __dp4a(h2, qh.z, a);
        acc[j] = __dp4a(h3, qh.w, a);
      }
    }
#pragma unroll
    for (int j = 0; j < kQueries; ++j)
      if (j < nqb)
        out[(size_t)(q0 + j) * n + row0 + r] =
            __fadd_rn(__fmul_rn((float)acc[j], scale), pen);
  }
}

}  // namespace

extern "C" {

// queries [nq, dim] int8, packed [n, dim / 2] int8 (16-byte aligned,
// dim % 32 == 0), scales and penalty [n] f32, out [nq, n] f32. Returns a
// cudaError_t as int.
int int4_scan(const void* queries, const void* packed, const void* scales,
              const void* penalty, void* out, int nq, int n, int dim,
              void* stream) {
  const size_t smem =
      (size_t)(kRows * (dim / 32 + 1) + kQueries * (dim / 16)) * sizeof(int4);
  cudaError_t err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kRows - 1) / kRows;
  scan<<<blocks, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(queries), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(penalty),
      static_cast<float*>(out), nq, n, dim);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
