// int8 gallery scan for Hopper (sm_90a).
//
// Replaces: the Pallas kernel `_scan_kernel`, launched by `int8_scan_scores`
// in retrieval_based_object_detection_tpu/ops/int8_scan.py. It computes the
// [Q, N] f32 scores q_i8 . gallery_i8^T + penalty as exact integers: every
// dot is an int32 sum, and 127^2 * D < 2^24 (D <= 1040, checked by the
// wrapper) makes its conversion to f32 exact, so the scores are bit-identical
// to int8_cosine_topk's int32 scores; the penalty is added once, rounded to
// nearest, as the plain version adds it. The Pallas kernel's bf16 detour,
// which works around a TPU codegen hang, has no counterpart here.
//
// Bound on the H100: bytes. At serving size (Q = 16, N = 1,048,576, D = 512)
// it must read the 512 MiB gallery once and write 64 MiB of scores, about
// 0.18 ms at 3.35 TB/s; its 17 G integer operations take 9 us at the int8
// tensor-core rate. The kernel this replaced formed the sums with __dp4a on
// the CUDA cores (2,048 a row, 2.1 G instructions at 1M rows) behind a block
// barrier after each tile's copy into shared memory. So the design is B3's
// (int4_scan.cu) without the unpack, aimed at bytes in flight. Measured on
// an H100 (700 W), in turns with that kernel: 0.225 ms at serving size
// against its 0.321, and 0.060 against 0.106 at one shard of a 4-shard tier
// (N = 294,912); torch._int_mm, cuBLASLt's int8 product of the same dots,
// takes 0.258 and 0.078 without the transpose and the penalty. With 4 chunks
// a step in place of 8, 3-7% slower; with evict-normal row loads, 5% faster
// at serving size and 10% slower at a shard.
//
// Design: 16 queries are the M of mma.sync.m16n8k32.s8 (mma_s8 of mma.cuh),
// 8 gallery rows its N, 32 dims its k. Blocks of 4 warps are persistent;
// each warp walks groups of 32 rows (four 8-row tiles) on its own, with no
// barrier after the queries are in shared memory.
// - A step is kLoads chunks of one tile's rows: a lane (g = lane / 4,
//   t = lane % 4) reads a piece of kPiece bytes of row g at byte
//   kChunk c + kPiece t for each chunk c of the step, straight into
//   registers. The four lanes of a row read kChunk contiguous bytes per load
//   (whole 32-byte sectors), and a step's loads together read kLoads kChunk
//   bytes of each of the tile's 8 rows in one piece: at D = 512 the whole
//   tile, 4 KB. The next step's loads are issued before this step's
//   arithmetic, across tile and group boundaries too, so every lane keeps
//   kLoads kPiece bytes in flight.
// - The order of the k positions is free as long as A holds the same dims:
//   each 8 bytes of a piece are one mma's B (b0 its first word, b1 its
//   second), and the lane's A registers are the same 8 bytes of queries g
//   and g + 8, read as one kPiece load each from shared memory.
// - The queries lie in shared memory padded with zeros to a multiple of
//   kChunk dims (the pieces past D load as zeros too; no load reads past the
//   end of a row or the last row), at a row stride equal to kChunk mod 128
//   bytes so a phase of the warp's shared loads meets no bank twice. Queries
//   past nq are zero rows.
// - A tile's 16 x 8 int32 sums go to the warp's own 2.5 KB of shared memory;
//   after the group's fourth tile lane r holds row r's penalty and writes,
//   query by query, 128 contiguous bytes of scores per instruction.
// - More than 16 queries run as passes over gridDim.y; the ragged last
//   group is masked, so N need not be a multiple of anything.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQueries = 16;        // queries per pass: the M of the mma
constexpr int kTiles = 4;           // 8-row tiles per warp and group
constexpr int kGroup = 8 * kTiles;  // rows per group
using Piece = int4;                 // a lane's bytes of a row per load
constexpr int kPiece = sizeof(Piece);
constexpr int kWords = kPiece / 4;  // words per piece; two per mma
constexpr int kChunk = 4 * kPiece;  // bytes of a row per load and warp
constexpr int kLoads = 8;           // chunks per step
constexpr int kStageLd = 40;        // staged sums: words per query row
constexpr int kScanBlocksPerSm = 3;

// Word m of a piece (m a constant once the loops are unrolled).
__device__ __forceinline__ uint32_t word(const int4& p, int m) {
  return (uint32_t)(m == 0 ? p.x : m == 1 ? p.y : m == 2 ? p.z : p.w);
}
__device__ __forceinline__ uint32_t word(const int2& p, int m) {
  return (uint32_t)(m == 0 ? p.x : p.y);
}

// Bytes of one query row in shared memory: dim_pad (a multiple of kChunk)
// rounded up to 128, plus kChunk: kChunk mod 128.
__host__ __device__ constexpr int query_stride(int dim_pad) {
  return (dim_pad + 127) / 128 * 128 + kChunk;
}

__global__ void __launch_bounds__(kThreads, kScanBlocksPerSm)
    scan(const int8_t* __restrict__ queries, const int8_t* __restrict__ rows,
         const float* __restrict__ penalty, float* __restrict__ out, int nq,
         int n, int dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nchunks = (dim + kChunk - 1) / kChunk;
  const int ldq = query_stride(nchunks * kChunk);
  unsigned char* qs = smem;  // [kQueries][ldq]
  int* stage = reinterpret_cast<int*>(smem + kQueries * ldq) +
               (threadIdx.x / 32) * kQueries * kStageLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * kQueries;
  const int nqb = min(kQueries, nq - q0);

  // The pass's queries, zeros past dim and in rows past nq.
  const int row16 = (ldq - kChunk) / 16;  // 16-byte pieces per query row
  for (int i = threadIdx.x; i < kQueries * row16; i += kThreads) {
    const int j = i / row16, c = (i % row16) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (j < nqb && c < dim)
      v = *reinterpret_cast<const int4*>(queries + (size_t)(q0 + j) * dim +
                                         c);
    *reinterpret_cast<int4*>(qs + j * ldq + c) = v;
  }
  __syncthreads();

  const int ngroups = (n + kGroup - 1) / kGroup;
  const int nwarps = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  if (first >= ngroups) return;
  const int mine = (ngroups - first + nwarps - 1) / nwarps;  // my groups
  const int nsteps = (nchunks + kLoads - 1) / kLoads;  // steps per tile
  const int steps = mine * kTiles * nsteps;

  // Step s is chunks kLoads (s % nsteps) .. of tile (s / nsteps) % kTiles of
  // my group s / (nsteps kTiles). Its loads: a piece of row g per chunk
  // (none past the last step), zeros where the gallery or the row ends (the
  // queries are 0 there).
  auto load = [&](int s, Piece (&buf)[kLoads]) {
    if (s >= steps) return;
    const int tile = s / nsteps;
    const long long r =
        (long long)(first + (tile / kTiles) * nwarps) * kGroup +
        (tile % kTiles) * 8 + g;
    const int byte0 = (s % nsteps) * kLoads * kChunk + t * kPiece;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int byte = byte0 + j * kChunk;
      buf[j] = (r < n && byte < dim)
                   ? __ldcs(reinterpret_cast<const Piece*>(rows + r * dim +
                                                           byte))
                   : Piece{};
    }
  };

  int acc[4];  // the tile's sums: query g, rows 2t and 2t + 1; query g + 8
  auto compute = [&](int s, const Piece (&cur)[kLoads]) {
    const int step = s % nsteps, tile = s / nsteps;
    if (step == 0) acc[0] = acc[1] = acc[2] = acc[3] = 0;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int c = step * kLoads + j;
      if (c < nchunks) {
        // A: the same bytes of queries g and g + 8.
        const unsigned char* qa = qs + g * ldq + c * kChunk + t * kPiece;
        const Piece pa = *reinterpret_cast<const Piece*>(qa);
        const Piece pb = *reinterpret_cast<const Piece*>(qa + 8 * ldq);
#pragma unroll
        for (int m = 0; m < kWords; m += 2) {
          const uint32_t a[4] = {word(pa, m), word(pb, m), word(pa, m + 1),
                                 word(pb, m + 1)};
          mma_s8(acc, a, word(cur[j], m), word(cur[j], m + 1));
        }
      }
    }
    if (step != nsteps - 1) return;

    // The tile's sums into the warp's stage; after the group's last tile
    // lane r takes row r of the group for every query.
    const int i = tile % kTiles;
    *reinterpret_cast<int2*>(stage + g * kStageLd + i * 8 + 2 * t) =
        make_int2(acc[0], acc[1]);
    *reinterpret_cast<int2*>(stage + (g + 8) * kStageLd + i * 8 + 2 * t) =
        make_int2(acc[2], acc[3]);
    if (i != kTiles - 1) return;
    __syncwarp();
    const long long r =
        (long long)(first + (tile / kTiles) * nwarps) * kGroup + lane;
    if (r < n) {
      const float pen = penalty[r];
#pragma unroll
      for (int j = 0; j < kQueries; ++j) {
        if (j < nqb)
          __stcs(out + (size_t)(q0 + j) * n + r,
                 __fadd_rn((float)stage[j * kStageLd + lane], pen));
      }
    }
    __syncwarp();  // the stage is read before the next group writes it
  };

  // The next step's loads are issued before this step's arithmetic.
  Piece next[kLoads];
  load(0, next);
  for (int s = 0; s < steps; ++s) {
    Piece cur[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) cur[j] = next[j];
    load(s + 1, next);
    compute(s, cur);
  }
}

}  // namespace

extern "C" {

// queries [nq, dim] int8, rows [n, dim] int8 (16-byte aligned,
// dim % 16 == 0), penalty [n] f32, out [nq, n] f32. Returns a cudaError_t
// as int.
int int8_scan(const void* queries, const void* rows, const void* penalty,
              void* out, int nq, int n, int dim, void* stream) {
  if (dim % 16 != 0 || dim < 16 || nq < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  const int dim_pad = (dim + kChunk - 1) / kChunk * kChunk;
  const size_t smem = (size_t)kQueries * query_stride(dim_pad) +
                      (size_t)kWarps * kQueries * kStageLd * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (n + kGroup - 1) / kGroup;
  const int want = (ngroups + kWarps - 1) / kWarps;
  const int most = sms * kScanBlocksPerSm;
  const dim3 grid(want < most ? want : most, (nq + kQueries - 1) / kQueries);
  scan<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(queries), static_cast<const int8_t*>(rows),
      static_cast<const float*>(penalty), static_cast<float*>(out), nq, n,
      dim);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
