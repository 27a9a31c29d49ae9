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
// as the plain version rounds them, so the scores agree bit for bit. As in
// the Pallas kernel, the nibbles enter the product with their bias of 8 left
// on (lo + 8 = b & 15 and hi + 8 = top nibble ^ 8, both in 0..15: three
// integer operations per four bytes), and 8 * sum_d q[d] is taken off each
// query's sum afterwards; integer arithmetic is exact, so nothing moves.
//
// Bound on the H100: bytes. At serving size (Q = 16, N = 1,048,576, D = 512)
// it must read the 256 MiB of packed rows and 8 MiB of scales and penalties
// once and write 64 MiB of scores, about 0.10 ms at 3.35 TB/s; its 17 G
// integer operations take 9 us at the int8 tensor-core rate. (Done with
// __dp4a, as the kernel this replaced did them, the 2.1 G instructions alone
// took longer than the bytes.) So the design is aimed at bytes in flight and
// at reading them in large contiguous pieces. Measured on an H100 at that
// size: 0.134 ms (the __dp4a kernel this replaced: 0.216 ms); with the same
// loads issued as one 64-byte chunk of four tiles a step, so that a tile's
// rows arrived over four steps, 0.162 ms.
//
// Design: 16 queries are the M of mma.sync.m16n8k32.s8 (mma_s8 of mma.cuh),
// 8 gallery rows its N, 32 dims its k. Blocks of 4 warps are persistent;
// each warp walks groups of 32 rows (four 8-row tiles) on its own, with no
// barrier after the queries are in shared memory.
// - A step is one tile's rows over four 64-byte chunks: a lane (g = lane / 4,
//   t = lane % 4) reads 16 packed bytes of row g at byte 64c + 16t for each
//   chunk c of the step, straight into registers. The four lanes of a row
//   read 64 contiguous bytes per load, whole 32-byte sectors, and the step's
//   four loads together the tile's 8 rows x 256 bytes, 2 KB in one piece at
//   D = 512. The next step's loads are issued before this step's
//   arithmetic, across tile and group boundaries too, so every lane keeps
//   64 bytes in flight.
// - Each of the four words of a load unpacks into two B registers
//   (low_biased: dims 64c + 16t + 4i .. + 3 of the row; high_biased: the
//   same dims + D/2). The order of the k positions is free as long as A
//   holds the same dims: a lane's A registers for a chunk are 16 contiguous
//   bytes of queries g and g + 8 at dim 64c + 16t, and the same at D/2 + ...,
//   four 16-byte loads from shared memory for four mma.
// - The queries lie in shared memory as two halves, each padded with zeros
//   to a multiple of 64 dims (a packed byte of 0 is not the value 0, so the
//   query is what must be 0 where a row has no byte), at a row stride of
//   64 mod 128 bytes so a quarter-warp's 16-byte loads meet no bank twice.
//   Queries past nq are zero rows.
// - A tile's 16 x 8 int32 sums go to the warp's own 2.5 KB of shared memory;
//   after the group's fourth tile lane r holds row r's scale and penalty,
//   takes each query's bias off, and writes, query by query, 128 contiguous
//   bytes of scores per instruction.
// - More than 16 queries run as passes over gridDim.y; the ragged last
//   group is masked, so N need not be a multiple of anything.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kQueries = 16;    // queries per pass: the M of the mma
constexpr int kTiles = 4;       // 8-row tiles per warp and group
constexpr int kGroup = 8 * kTiles;  // rows per group
constexpr int kChunk = 64;      // packed bytes of a row per load and warp
constexpr int kLoads = 4;       // chunks per step
constexpr int kStageLd = 40;    // staged sums: words per query row
constexpr int kBlocksPerSm = 4;

// lo + 8 in each byte: b = 16 hi + lo + 8 with lo + 8 in 0..15.
__device__ __forceinline__ uint32_t low_biased(int w) {
  return (uint32_t)w & 0x0F0F0F0Fu;
}

// hi + 8 in each byte: the top nibble u is hi mod 16 (hi = floor(b / 16), in
// -8..7), and u ^ 8 is hi + 8.
__device__ __forceinline__ uint32_t high_biased(int w) {
  return (((uint32_t)w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// Bytes of one query row in shared memory: two halves of half_pad bytes (a
// multiple of 64), then 64 of padding: 64 mod 128.
__host__ __device__ constexpr int query_stride(int half_pad) {
  return 2 * half_pad + 64;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    scan(const int8_t* __restrict__ queries, const int8_t* __restrict__ packed,
         const float* __restrict__ scales, const float* __restrict__ penalty,
         float* __restrict__ out, int nq, int n, int dim) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = dim / 2;  // packed bytes per row, dims per query half
  const int nchunks = (half + kChunk - 1) / kChunk;
  const int half_pad = nchunks * kChunk;
  const int ldq = query_stride(half_pad);
  unsigned char* qs = smem;  // [kQueries][ldq]
  int* bias = reinterpret_cast<int*>(smem + kQueries * ldq);  // [kQueries]
  int* stage = bias + kQueries + (threadIdx.x / 32) * kQueries * kStageLd;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * kQueries;
  const int nqb = min(kQueries, nq - q0);

  // The pass's queries: dims [0, D/2) and [D/2, D) at 0 and half_pad of
  // the row, zeros behind each and in rows past nq.
  const int row16 = 2 * half_pad / 16;  // 16-byte pieces per query row
  for (int i = threadIdx.x; i < kQueries * row16; i += kThreads) {
    const int j = i / row16, c = (i % row16) * 16;
    const int d = c < half_pad ? c : c - half_pad;  // offset in its half
    int4 v = make_int4(0, 0, 0, 0);
    if (j < nqb && d < half)
      v = *reinterpret_cast<const int4*>(
          queries + (size_t)(q0 + j) * dim + (c < half_pad ? 0 : half) + d);
    *reinterpret_cast<int4*>(qs + j * ldq + c) = v;
  }
  __syncthreads();
  // bias[j] = 8 * sum_d q[j][d]: what the nibbles' bias of 8 adds to a sum.
  for (int j = warp; j < kQueries; j += kWarps) {
    const int* row = reinterpret_cast<const int*>(qs + j * ldq);
    int sum = 0;
    for (int w = lane; w < 2 * half_pad / 4; w += 32)
      sum = __dp4a(row[w], 0x01010101, sum);
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) bias[j] = 8 * sum;
  }
  __syncthreads();

  const int ngroups = (n + kGroup - 1) / kGroup;
  const int nwarps = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  if (first >= ngroups) return;
  const int mine = (ngroups - first + nwarps - 1) / nwarps;  // my groups
  const int nquads = (nchunks + kLoads - 1) / kLoads;  // steps per tile
  const int steps = mine * kTiles * nquads;

  // Step s is chunks kLoads (s % nquads) .. of tile (s / nquads) % kTiles of
  // my group s / (nquads kTiles). Its loads: 16 bytes of row g per chunk
  // (none past the last step), zeros where the gallery or the row ends (the
  // queries are 0 there).
  auto load = [&](int s, int4 (&buf)[kLoads]) {
    if (s >= steps) return;
    const int tile = s / nquads;
    const long long r =
        (long long)(first + (tile / kTiles) * nwarps) * kGroup +
        (tile % kTiles) * 8 + g;
    const int byte0 = (s % nquads) * kLoads * kChunk + t * 16;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int byte = byte0 + j * kChunk;
      buf[j] = (r < n && byte < half)
                   ? __ldcs(reinterpret_cast<const int4*>(packed + r * half +
                                                          byte))
                   : make_int4(0, 0, 0, 0);
    }
  };

  int acc[4];  // the tile's sums: query g, rows 2t and 2t + 1; query g + 8
  auto compute = [&](int s, const int4 (&cur)[kLoads]) {
    const int quad = s % nquads, tile = s / nquads;
    if (quad == 0) acc[0] = acc[1] = acc[2] = acc[3] = 0;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int c = quad * kLoads + j;
      if (c < nchunks) {
        // A: queries g and g + 8, 16 dims of each half.
        const unsigned char* qa = qs + g * ldq + c * kChunk + t * 16;
        const int4 la = *reinterpret_cast<const int4*>(qa);
        const int4 lb = *reinterpret_cast<const int4*>(qa + 8 * ldq);
        const int4 ha = *reinterpret_cast<const int4*>(qa + half_pad);
        const int4 hb = *reinterpret_cast<const int4*>(qa + 8 * ldq + half_pad);
        const uint32_t al0[4] = {(uint32_t)la.x, (uint32_t)lb.x,
                                 (uint32_t)la.y, (uint32_t)lb.y};
        const uint32_t al1[4] = {(uint32_t)la.z, (uint32_t)lb.z,
                                 (uint32_t)la.w, (uint32_t)lb.w};
        const uint32_t ah0[4] = {(uint32_t)ha.x, (uint32_t)hb.x,
                                 (uint32_t)ha.y, (uint32_t)hb.y};
        const uint32_t ah1[4] = {(uint32_t)ha.z, (uint32_t)hb.z,
                                 (uint32_t)ha.w, (uint32_t)hb.w};
        const int4 w = cur[j];
        mma_s8(acc, al0, low_biased(w.x), low_biased(w.y));
        mma_s8(acc, al1, low_biased(w.z), low_biased(w.w));
        mma_s8(acc, ah0, high_biased(w.x), high_biased(w.y));
        mma_s8(acc, ah1, high_biased(w.z), high_biased(w.w));
      }
    }
    if (quad != nquads - 1) return;

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
      const float scale = scales[r], pen = penalty[r];
#pragma unroll
      for (int j = 0; j < kQueries; ++j) {
        if (j < nqb)
          __stcs(out + (size_t)(q0 + j) * n + r,
                 __fadd_rn(__fmul_rn((float)(stage[j * kStageLd + lane] -
                                             bias[j]),
                                     scale),
                           pen));
      }
    }
    __syncwarp();  // the stage is read before the next group writes it
  };

  // The next step's loads are issued before this step's arithmetic.
  int4 next[kLoads];
  load(0, next);
  for (int s = 0; s < steps; ++s) {
    int4 cur[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) cur[j] = next[j];
    load(s + 1, next);
    compute(s, cur);
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
  if (dim % 32 != 0 || nq < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const int half_pad = (dim / 2 + kChunk - 1) / kChunk * kChunk;
  const size_t smem =
      (size_t)kQueries * query_stride(half_pad) +
      (size_t)(kQueries + kWarps * kQueries * kStageLd) * sizeof(int);
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
  const int blocks = want < sms * kBlocksPerSm ? want : sms * kBlocksPerSm;
  const dim3 grid(blocks, (nq + kQueries - 1) / kQueries);
  scan<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(queries), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(penalty),
      static_cast<float*>(out), nq, n, dim);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
