// Hopper (sm_90a) building blocks shared by the tensor-core kernels in this
// directory (attention.cu, clip_attention.cu, medoid.cu, int4_scan.cu):
// asynchronous copies into shared memory, ldmatrix, mma.sync for bf16, TF32
// and int8, the 3xTF32 and bf16 hi/lo splits, and small conversion helpers. Everything is a __device__ inline function,
// so each source that includes this header gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b, a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, a 16x8 tf32 (row), b 8x8 tf32 (col), d 16x8 f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, a 16x32 int8 (row), b 32x8 int8 (col), d 16x8 int32, exact.
// With g = lane / 4 and t = lane % 4: a[0] is row g, k 4t .. 4t + 3 (one
// byte each, the lowest byte the lowest k), a[1] row g + 8 of the same k,
// a[2] and a[3] the same rows at k 16 + 4t ..; b0 is column g, k 4t .. 4t + 3,
// b1 column g, k 16 + 4t ..; d[0], d[1] are row g, columns 2t and 2t + 1,
// d[2], d[3] row g + 8.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded to tf32 (half a tf32 ulp added, the low 13
// bits cleared), lo = x - hi exactly in f32, whose low mantissa bits the
// tf32 mma ignores. Two integer ops and a subtraction: with cvt.rna.tf32
// for hi and lo instead, the f32 flash kernel at SAM-B's global shape took
// 7.74 against 4.97 ms, for results within 4e-7 of these.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b in 3xTF32 with both operands split already: the small cross
// terms first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bl0,
                                           uint32_t bh1, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// d += a b in 3xTF32 with the running sum kept outside the tensor core. The
// tensor core adds into its accumulator by truncation (round toward zero),
// so a long chain of mma on one accumulator drifts toward zero by about half
// an ulp of the running sum per step: measured on the H100, 512-d dots near 1
// came out 6e-6 low, which moved the distance sums of near-duplicate rows by
// 0.5%. Here the three products of one k8 step start from zero and their sum
// is added to d by a round-to-nearest f32 add, as a CUDA-core f32 product
// would: the same rows then agree with float64 as well as torch.matmul does.
__device__ __forceinline__ void mma_3xtf32_rn(float (&d)[4],
                                              const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4],
                                              uint32_t bh0, uint32_t bl0,
                                              uint32_t bh1, uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(t, ah, al, bh0, bl0, bh1, bl1);
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

// d += a b in 3xTF32, splitting b's two f32 values here.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_3xtf32(d, ah, al, bh0, bl0, bh1, bl1);
}

// The same with the running sum kept outside the tensor core.
__device__ __forceinline__ void mma_3xtf32_rn(float (&d)[4],
                                              const uint32_t (&ah)[4],
                                              const uint32_t (&al)[4],
                                              float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_3xtf32_rn(d, ah, al, bh0, bl0, bh1, bl1);
}

// 2^x on the special-function unit; a denormal result flushes to 0. Same
// results as exp2f on the card tests, 5% less time in the bf16 flash kernels.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two f32 values as bf16 pairs hi = rn(x) and lo = rn(x - hi): hi + lo
// carries 16 mantissa bits of x, so a product taken once with each differs
// from the f32 product by 2^-17 of the term.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
