// Blocked medoid distance sums for Hopper (sm_90a), on the tensor cores.
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
// Bound on the H100: operations. The sums need each unordered pair's distance
// once: n (n - 1) / 2 dot products of 2 D operations, 7.4e10 at n = 12,000,
// D = 512. The card's fastest f32-accurate product is 3xTF32 on the tensor
// cores (three TF32 products at 495 TFLOP/s for one f32 product, 165 TFLOP/s):
// 0.45 ms; the 24.6 MB of rows take 7 us to read. One TF32 product alone is
// ruled out: its 10-bit mantissa moves d2 of close members (a difference of
// nearly equal numbers) far more than the tolerance the medoid's argmin is
// held to. 3xTF32 splits each operand into a tf32 hi and the f32 rest lo and
// adds lo hi + hi lo + hi hi, which keeps f32 accuracy as long as the running
// sum is not left in the tensor core: its accumulator truncates, and over the
// 192 mma of a 512-d dot that bias alone moved the sums of near-duplicate
// rows by 0.5%, 20 times the tolerance. So each k8 step's three products
// start from zero and are added to the accumulator by a round-to-nearest f32
// add (mma_3xtf32_rn in mma.cuh): 4 adds per 3 mma, 13% more time, and the
// same rows then agree with float64 direct distances as torch.matmul's do.
// Measured on an H100 at n = 12,000, D = 512: 1.45 ms (the CUDA-core kernel
// over the whole matrix that this replaced: 6.4 ms). Splitting at use costs
// 4% (timed with the splits left out), so the panels are not pre-split.
//
// Design:
// - Symmetry. The rows are cut into tiles of 128 and only tile pairs (a, b)
//   with a <= b are computed, one block each. An off-diagonal tile gives its
//   row sums to tile a's rows and its column sums to tile b's rows; a diagonal
//   tile gives row sums only. No float atomics: pair (a, b) writes the slot
//   partial[b][rows of a] and the slot partial[a][rows of b], so every
//   (tile, row) slot is written exactly once, and a last kernel adds each
//   row's slots in tile order. The sums, and so the argmin, are the same on
//   every run.
// - The Gram tile on mma.sync.m16n8k8 in 3xTF32. A block of 8 warps owns a
//   128 x 128 tile, each warp a 64 x 32 sub-tile as 4 x 4 accumulator
//   fragments in registers. The two row panels, 32 dims deep, come into shared
//   memory by 16-byte cp.async in two stages, so panel k + 1 loads while panel
//   k multiplies; rows past n and dims past D are zero-filled. Rows are padded
//   to 40 floats, so a half-warp's 8-byte fragment loads hit distinct banks:
//   the k8 chunk's columns t and t + 4 (t = lane % 4) hold dims 2t and 2t + 1
//   of both operands (any order of the dims gives the same dots). Each
//   fragment is split into hi and lo once per k8 step and reused by the four
//   products it feeds.
// - The epilogue turns the dots into distances (the row norms come from a
//   small pre-pass, one warp per row), forces the diagonal to 0 by global
//   index, clamps, takes the root and masks rows and columns past n. Row sums
//   are reduced over the quad of lanes that share a row, column sums over the
//   eight lanes that share a column (xor shuffles: the same value on every
//   lane), then across the warps of the block through shared memory in warp
//   order.
// - Scratch. partial[slots, n] grows as n^2 / 128 with one slot per tile, so
//   the caller caps `slots` and the launcher walks super-blocks of `slots`
//   row tiles in a fixed order: for each pair of super-blocks (I <= J) it
//   runs the tile pairs between them and adds their slots into `sums` before
//   the next pair reuses the scratch.

#include <cuda_runtime.h>

#include <stdint.h>

#include <algorithm>

#include "mma.cuh"

namespace {

constexpr int kTile = 128;     // rows and columns of one distance tile
constexpr int kDepth = 32;     // dims per shared-memory panel
constexpr int kLd = kDepth + 8;  // padded panel row, floats
constexpr int kPanel = kTile * kLd;  // floats of one panel stage
constexpr int kThreads = 256;  // 8 warps, 2 x 4 over the tile
constexpr int kWarpRows = 64, kWarpCols = 32;
constexpr int kMT = kWarpRows / 16;  // 16-row accumulator tiles per warp
constexpr int kNT = kWarpCols / 8;   // 8-column accumulator tiles per warp
// Two stages of both panels, the tile's row norms, and the cross-warp sums.
constexpr size_t kSmemBytes =
    (4 * kPanel + 2 * kTile + 4 * kTile + 2 * kTile) * sizeof(float);

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

// One block per tile pair (a, b), a <= b, between the super-blocks of row
// tiles [tile_i0, tile_i0 + tiles_i) and [tile_j0, tile_j0 + tiles_j); the
// two are the same super-block or disjoint, I before J.
// Two blocks an SM (128 registers a thread, 86 KB each): one block's loads
// and barriers hide behind the other's products, 8% less time than one block
// of 141 registers, for 84 bytes of spills.
__global__ void __launch_bounds__(kThreads, 2)
    tile_sums(const float* __restrict__ x, const float* __restrict__ sq,
              float* __restrict__ partial, int n, int dim, int tile_i0,
              int tiles_i, int tile_j0, int tiles_j) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;               // [2][kTile][kLd] rows of tile a
  float* bs = as + 2 * kPanel;    // [2][kTile][kLd] rows of tile b
  float* sqa = bs + 2 * kPanel;   // [kTile] norms of tile a's rows
  float* sqb = sqa + kTile;       // [kTile] norms of tile b's rows
  float* red_row = sqb + kTile;   // [4][kTile] row sums per warp column
  float* red_col = red_row + 4 * kTile;  // [2][kTile] column sums per warp row

  // The block's pair. Inside one super-block the pairs a <= b are numbered
  // down the columns of the upper triangle; between two, all pairs.
  int a, b;
  const int p = blockIdx.x;
  if (tile_i0 == tile_j0) {
    int bb = (int)((sqrtf(8.f * (float)p + 1.f) - 1.f) * 0.5f);
    while (bb * (bb + 1) / 2 > p) --bb;
    while ((bb + 1) * (bb + 2) / 2 <= p) ++bb;
    a = tile_i0 + p - bb * (bb + 1) / 2;
    b = tile_i0 + bb;
  } else {
    a = tile_i0 + p % tiles_i;
    b = tile_j0 + p / tiles_i;
  }
  const int row0 = a * kTile, col0 = b * kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row and column group
  const int wm = warp >> 2, wn = warp & 3;
  const int wrow = wm * kWarpRows, wcol = wn * kWarpCols;

  // Panel kp of both tiles into stage `stage`, async; zero past n and dim.
  // dim % 4 == 0: a 16-byte chunk is all in or all out.
  auto load_panel = [&](int kp, int stage) {
    const int k0 = kp * kDepth;
    float* ad = as + stage * kPanel;
    float* bd = bs + stage * kPanel;
    for (int i = threadIdx.x; i < kTile * (kDepth / 4); i += kThreads) {
      const int r = i / (kDepth / 4), c = (i % (kDepth / 4)) * 4;
      const bool in_dim = k0 + c < dim;
      const bool oka = in_dim && row0 + r < n;
      const bool okb = in_dim && col0 + r < n;
      cp_async16(ad + r * kLd + c,
                 x + (oka ? (size_t)(row0 + r) * dim + k0 + c : 0), oka);
      cp_async16(bd + r * kLd + c,
                 x + (okb ? (size_t)(col0 + r) * dim + k0 + c : 0), okb);
    }
  };

  load_panel(0, 0);
  cp_async_commit();
  if (threadIdx.x < kTile) {
    const int r = row0 + threadIdx.x;
    sqa[threadIdx.x] = r < n ? sq[r] : 0.f;
  } else {
    const int c = col0 + threadIdx.x - kTile;
    sqb[threadIdx.x - kTile] = c < n ? sq[c] : 0.f;
  }

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  const int panels = (dim + kDepth - 1) / kDepth;
  for (int kp = 0; kp < panels; ++kp) {
    const int stage = kp & 1;
    if (kp + 1 < panels) {
      load_panel(kp + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // panel kp (and the norms) visible to every warp

    const float* at = as + stage * kPanel + (wrow + gq) * kLd + 2 * tq;
    const float* bt = bs + stage * kPanel + (wcol + gq) * kLd + 2 * tq;
#pragma unroll
    for (int k8 = 0; k8 < kDepth / 8; ++k8) {
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const float2 r0 =
            *reinterpret_cast<const float2*>(at + mi * 16 * kLd + k8 * 8);
        const float2 r8 =
            *reinterpret_cast<const float2*>(at + (mi * 16 + 8) * kLd + k8 * 8);
        split_tf32(r0.x, ah[mi][0], al[mi][0]);
        split_tf32(r8.x, ah[mi][1], al[mi][1]);
        split_tf32(r0.y, ah[mi][2], al[mi][2]);
        split_tf32(r8.y, ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const float2 bv =
            *reinterpret_cast<const float2*>(bt + ni * 8 * kLd + k8 * 8);
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(bv.x, bh0, bl0);
        split_tf32(bv.y, bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
          mma_3xtf32_rn(acc[mi][ni], ah[mi], al[mi], bh0, bl0, bh1, bl1);
      }
    }
    __syncthreads();  // stage kp is consumed before it is loaded again
  }

  // Distances, and this thread's part of 8 row sums and 8 column sums.
  // Accumulator element e of tile (mi, ni): row gq + 8 (e / 2), column
  // 2 tq + e % 2.
  float rs[kMT][2], cs[kNT][2];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) rs[mi][0] = rs[mi][1] = 0.f;
#pragma unroll
  for (int ni = 0; ni < kNT; ++ni) cs[ni][0] = cs[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = wrow + mi * 16 + gq + (e >> 1) * 8;
        const int lc = wcol + ni * 8 + 2 * tq + (e & 1);
        const int r = row0 + lr, c = col0 + lc;
        float d2 = __fsub_rn(__fadd_rn(sqa[lr], sqb[lc]),
                             __fmul_rn(2.f, acc[mi][ni][e]));
        // Clamp before the root: the Gram trick can leave a tiny negative.
        // Self-distances are exactly 0 (by global index).
        d2 = r == c ? 0.f : fmaxf(d2, 0.f);
        const float d = (r < n && c < n) ? sqrtf(d2) : 0.f;
        rs[mi][e >> 1] += d;
        cs[ni][e & 1] += d;
      }
    }
  }
  // Within the warp: the quad shares a row, the eight lanes of one tq share
  // a column. Then one slot per warp column (rows) and warp row (columns).
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = rs[mi][hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tq == 0) red_row[wn * kTile + wrow + mi * 16 + gq + hh * 8] = v;
    }
  }
#pragma unroll
  for (int ni = 0; ni < kNT; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = cs[ni][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gq == 0) red_col[wm * kTile + wcol + ni * 8 + 2 * tq + j] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int t = threadIdx.x, r = row0 + t;
    if (r < n)
      partial[(size_t)(b - tile_j0) * n + r] =
          ((red_row[t] + red_row[kTile + t]) + red_row[2 * kTile + t]) +
          red_row[3 * kTile + t];
  } else if (a != b) {
    const int t = threadIdx.x - kTile, c = col0 + t;
    if (c < n)
      partial[(size_t)(a - tile_i0) * n + c] = red_col[t] + red_col[kTile + t];
  }
}

// sums[r] += partial[0][r] + ... + partial[slots - 1][r], in slot order, for
// the rows [row_begin, row_end).
__global__ void add_partials(const float* __restrict__ partial,
                             float* __restrict__ sums, int n, int row_begin,
                             int row_end, int slots) {
  const int r = row_begin + blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= row_end) return;
  float s = 0.f;
  for (int g = 0; g < slots; ++g) s += partial[(size_t)g * n + r];
  sums[r] += s;
}

}  // namespace

extern "C" {

// x [n, dim] f32 (16-byte aligned, dim % 4 == 0); scratch sq [n] and
// partial [slots, n] f32, slots >= 1; out sums [n] f32. With slots <
// ceil(n / 128) the row tiles are walked in super-blocks of `slots`.
// Returns a cudaError_t as int.
int medoid_sums(const void* x, void* sq, void* partial, void* sums, int n,
                int dim, int slots, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* sqf = static_cast<float*>(sq);
  float* pf = static_cast<float*>(partial);
  float* sf = static_cast<float*>(sums);
  if (slots < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tile_sums, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(sf, 0, (size_t)n * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  row_norms<<<(n + 7) / 8, 256, 0, s>>>(xf, sqf, n, dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + kTile - 1) / kTile;
  auto add = [&](int tile0, int count, int used) {
    const int begin = tile0 * kTile;
    const int end = std::min(n, (tile0 + count) * kTile);
    add_partials<<<(end - begin + 255) / 256, 256, 0, s>>>(pf, sf, n, begin,
                                                           end, used);
    return cudaGetLastError();
  };
  for (int i0 = 0; i0 < tiles; i0 += slots) {
    const int ti = std::min(slots, tiles - i0);
    for (int j0 = i0; j0 < tiles; j0 += slots) {
      const int tj = std::min(slots, tiles - j0);
      const int pairs = i0 == j0 ? ti * (ti + 1) / 2 : ti * tj;
      tile_sums<<<pairs, kThreads, kSmemBytes, s>>>(xf, sqf, pf, n, dim, i0,
                                                    ti, j0, tj);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      // Rows of I hold one slot per tile of J, rows of J one per tile of I.
      err = add(i0, ti, tj);
      if (err != cudaSuccess) return (int)err;
      if (i0 != j0) {
        err = add(j0, tj, ti);
        if (err != cudaSuccess) return (int)err;
      }
    }
  }
  return (int)cudaSuccess;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
