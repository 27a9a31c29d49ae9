// Merge of the sharded int8 tier for Hopper (sm_90a): per query, the best k
// of S shards' rescored candidates, on the first shard's card.
//
// Replaces no Pallas kernel. The JAX package's sharded tier takes lax.top_k
// on each shard, all-gathers the shards' lists and takes lax.top_k over
// them. The port did that in about 32 eager operations from the host after
// the shards' graph replays (a torch.topk and a gather per shard, the copies
// to the first card, casts, offsets, a stable sort and two gathers). This
// kernel takes the best k of the union of the shards' rescored candidates
// ([Q, r] f32 scores and [Q, r] int64 local rows a shard, read where they
// lie: on the first card, or on a peer over NVLink) in one launch.
//
// Bound on the H100: latency, not bytes. It reads S Q r 12 bytes and writes
// Q k 12: 196,608 and 1,920 bytes at the sharded cell's S = 4, Q = 16,
// r = 256, k = 10, 0.06 us at 3.35 TB/s. A block takes one query through
// a few dependent passes over its S r candidates in shared memory; the
// peers' latency and the passes' barriers set its time.
//
// The rule: score descending, then shard ascending, then position in the
// shard's list ascending, which is lax.top_k on each shard followed by
// lax.top_k over the lists gathered in shard order. With c = shard r +
// position, that is (score descending, c ascending). Scores compare as
// floats (-0 equals +0) and are never NaN. NEG_INF candidates (the masked
// rows the candidate select filled in) sort after every live one, among
// themselves by c, and keep their score, so that a query's hits end at the
// first of them.
//
// Design: a block of 256 threads a query.
// 1. The scores' 32-bit order keys: the first kStage candidates' in shared
//    memory; past them a key is read again where it is needed.
// 2. A radix select of the k-th largest key T in four 8-bit digits: a
//    histogram of the digit over the keys that match the digits found so
//    far (one shared atomic per distinct digit of a warp), then the bin
//    where the count from the top reaches what is still wanted. A: the keys
//    above T; need = k - A of the keys at T are taken, the lowest c first.
// 3. Each thread counts its contiguous run of candidates above and at T; a
//    block scan of the two counts gives every chosen candidate a slot: those
//    above T in c order in [0, A), the first `need` at T in c order in
//    [A, k). Each writes its c and score to the query's staging words.
// 4. A slot below A finds its rank among the A by comparing with the other
//    A - 1; the slots at T are in place. Each writes its score and its
//    global row (local row + shard rows_per) to the output.
// The wrapper's one buffer holds the global rows [Q, k] int64, the scores
// [Q, k] f32 (padded to 8 bytes) and the staging words [Q, k], in that
// order, so that the host copies the first two back at once.
//
// Cross-card order without a host sync: the launcher records an event on
// each other shard's stream (after its replay) that the first card's stream
// waits for before the merge, and one after the merge that each of those
// streams waits for, so that no later work there (the next replay over the
// same static outputs) starts before the merge has read them.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // a block; also a digit's bins
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kStage = 4096;  // candidates' keys kept in shared memory
constexpr int kMaxShards = 64;

static_assert(kThreads == kBins, "the digit search takes a bin a thread");

struct Shards {
  const float* scores[kMaxShards];    // [nq, r] each
  const long long* rows[kMaxShards];  // [nq, r] each
};

// A score's order key: larger keys for larger scores, -0 as +0.
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned b = __float_as_uint(v == 0.f ? 0.f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

struct Cut {
  int bin;    // the largest bin whose count from the top reaches `want`
  int above;  // keys in the bins above it
};

// Over a 256-bin histogram in shared memory that holds at least `want`
// keys: the largest bin b whose count of keys in bins >= b reaches `want`,
// and the count above b. Every thread calls it; thread t takes bin 255 - t.
__device__ Cut top_bin(const int* hist, int want) {
  __shared__ int warp_sums[kWarps];
  __shared__ Cut cut;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int x = hist[kBins - 1 - t];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x += warp_sums[w];
  // x, the keys in bins >= 255 - t, grows with t.
  const int short_of = __syncthreads_count(x < want);
  if (short_of == 0 ? t == 0 : t == short_of - 1)
    cut = Cut{kBins - 1 - short_of, short_of == 0 ? 0 : x};
  __syncthreads();
  return cut;
}

// The exclusive prefix, in thread order, of each thread's `v`.
__device__ unsigned long long block_exclusive(unsigned long long v) {
  __shared__ unsigned long long warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x += warp_sums[w];
  return x - v;
}

struct Query {
  const Shards* sh;
  size_t base;  // the query's first element in a shard's [nq, r] lists
  int r;
  __device__ __forceinline__ float score(int c) const {
    const int s = c / r;
    return sh->scores[s][base + (c - s * r)];
  }
  __device__ __forceinline__ long long row(int c, long long rows_per) const {
    const int s = c / r;
    return sh->rows[s][base + (c - s * r)] + s * rows_per;
  }
};

__global__ void __launch_bounds__(kThreads)
    shard_merge_kernel(const __grid_constant__ Shards sh, int r, int n,
                       long long rows_per, int k,
                       long long* __restrict__ out_rows,
                       float* __restrict__ out_scores,
                       unsigned long long* staging) {
  __shared__ unsigned stage[kStage];
  __shared__ int hist[kBins];
  const int t = threadIdx.x, lane = t & 31;
  const Query qr{&sh, (size_t)blockIdx.x * r, r};
  const int staged = min(n, kStage);
  for (int c = t; c < staged; c += kThreads) stage[c] = key_of(qr.score(c));
  __syncthreads();
  auto key = [&](int c) {
    return c < kStage ? stage[c] : key_of(qr.score(c));
  };

  // 2. The k-th largest key T, a digit a pass.
  const int m = (n + kThreads - 1) / kThreads;
  unsigned prefix = 0;
  int want = k, above = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[t] = 0;
    __syncthreads();
    const unsigned high = shift == 24 ? 0u : ~0u << (shift + 8);
    for (int j = 0; j < m; ++j) {
      const int c = j * kThreads + t;
      int digit = -1;
      if (c < n) {
        const unsigned kc = key(c);
        if ((kc & high) == prefix) digit = (kc >> shift) & (kBins - 1);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[digit], __popc(peers));
    }
    __syncthreads();
    const Cut cut = top_bin(hist, want);
    prefix |= (unsigned)cut.bin << shift;
    above += cut.above;
    want -= cut.above;
  }
  const unsigned T = prefix;
  const int need = want;

  // 3. Slots: above T in c order, then the first `need` at T in c order.
  const int c0 = min(n, t * m), c1 = min(n, c0 + m);
  unsigned n_above = 0, n_tied = 0;
  for (int c = c0; c < c1; ++c) {
    const unsigned kc = key(c);
    n_above += kc > T;
    n_tied += kc == T;
  }
  const unsigned long long before =
      block_exclusive((unsigned long long)n_above << 32 | n_tied);
  unsigned slot_above = (unsigned)(before >> 32);
  unsigned tied = (unsigned)before;
  unsigned long long* const st = staging + (size_t)blockIdx.x * k;
  for (int c = c0; c < c1; ++c) {
    const unsigned kc = key(c);
    int slot = -1;
    if (kc > T) {
      slot = (int)slot_above++;
    } else if (kc == T) {
      if (tied < (unsigned)need) slot = above + (int)tied;
      ++tied;
    }
    if (slot >= 0)
      st[slot] = (unsigned long long)c << 32 | __float_as_uint(qr.score(c));
  }
  __syncthreads();

  // 4. Ranks among the A above T; then the output.
  float* const os = out_scores + (size_t)blockIdx.x * k;
  long long* const orow = out_rows + (size_t)blockIdx.x * k;
  for (int e = t; e < k; e += kThreads) {
    const unsigned long long w = st[e];
    const int c = (int)(w >> 32);
    const float v = __uint_as_float((unsigned)w);
    int rank = e;
    if (e < above) {
      const unsigned kv = key_of(v);
      rank = 0;
      for (int j = 0; j < above; ++j) {
        const unsigned long long o = st[j];
        const unsigned ko = key_of(__uint_as_float((unsigned)o));
        rank += ko > kv || (ko == kv && (int)(o >> 32) < c);
      }
    }
    os[rank] = v;
    orow[rank] = qr.row(c, rows_per);
  }
}

// `later` (on card `later_dev`) waits for the work so far on `earlier` (on
// card `earlier_dev`). A stream is named by its card and its handle: the
// handle 0 is each card's own default stream. Leaves `earlier_dev` current.
cudaError_t order(cudaStream_t earlier, int earlier_dev, cudaStream_t later,
                  int later_dev) {
  cudaEvent_t ev;
  cudaError_t err = cudaSetDevice(earlier_dev);
  if (err == cudaSuccess)
    err = cudaEventCreateWithFlags(&ev, cudaEventDisableTiming);
  if (err != cudaSuccess) return err;
  err = cudaEventRecord(ev, earlier);
  if (err == cudaSuccess) err = cudaSetDevice(later_dev);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(later, ev, 0);
  // Destroyed on its own card; the wait already holds the record.
  cudaError_t done = cudaSetDevice(earlier_dev);
  if (done == cudaSuccess) done = cudaEventDestroy(ev);
  return err != cudaSuccess ? err : done;
}

}  // namespace

extern "C" {

// scores[s], rows[s]: shard s's [nq, r] f32 scores and int64 local rows,
// contiguous, on card devices[s], whose work on them so far is on
// streams[s]; the first card is current and `stream` is its stream. out: the
// buffer of nq k (8 + 4 + 8) bytes (the last 4 n k rounded up to 8-byte
// words). 1 <= k <= shards r. Returns a cudaError_t as int.
int shard_merge(const void* const* scores, const void* const* rows,
                void* const* streams, const int* devices, int shards,
                int nq, int r, long long rows_per, int k, void* out,
                void* stream) {
  if (shards < 1 || shards > kMaxShards || nq < 1 || r < 1 ||
      (long long)shards * r > INT_MAX || k < 1 || k > shards * r)
    return (int)cudaErrorInvalidValue;
  int first;
  cudaError_t err = cudaGetDevice(&first);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shards sh;
  for (int s = 0; s < shards; ++s) {
    sh.scores[s] = static_cast<const float*>(scores[s]);
    sh.rows[s] = static_cast<const long long*>(rows[s]);
  }
  // The other streams, once each, in shard order.
  auto other = [&](int s) {
    const cudaStream_t x = static_cast<cudaStream_t>(streams[s]);
    if (devices[s] == first && x == st) return false;
    for (int j = 0; j < s; ++j)
      if (devices[j] == devices[s] && streams[j] == streams[s]) return false;
    return true;
  };
  for (int s = 0; s < shards && err == cudaSuccess; ++s)
    if (other(s))
      err = order(static_cast<cudaStream_t>(streams[s]), devices[s], st,
                  first);
  // The launch goes to the current card's stream `st`: the first card's.
  if (err == cudaSuccess) err = cudaSetDevice(first);
  if (err != cudaSuccess) {
    cudaSetDevice(first);
    return (int)err;
  }
  const long long nk = (long long)nq * k;
  long long* const out_rows = static_cast<long long*>(out);
  float* const out_scores = reinterpret_cast<float*>(out_rows + nk);
  unsigned long long* const staging =
      reinterpret_cast<unsigned long long*>(out_rows + nk + (nk + 1) / 2);
  shard_merge_kernel<<<nq, kThreads, 0, st>>>(sh, r, shards * r, rows_per, k,
                                              out_rows, out_scores, staging);
  err = cudaGetLastError();
  for (int s = 0; s < shards && err == cudaSuccess; ++s)
    if (other(s))
      err = order(st, first, static_cast<cudaStream_t>(streams[s]),
                  devices[s]);
  const cudaError_t back = cudaSetDevice(first);
  return (int)(err != cudaSuccess ? err : back);
}

// Lets the current card read `peer`'s memory (0 where it already could).
int shard_merge_enable_peer(int peer) {
  const cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clears it
    return 0;
  }
  return (int)err;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
