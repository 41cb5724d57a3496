// Shared pieces of the float32 flash kernels (flash_attention_f32.cu, the
// forward with or without its log-sum-exp; flash_attention_bwd_f32.cu, dq
// and dk/dv): constants, the asynchronous row copies and the 3xTF32
// tensor-core product.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lss_f32 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;  // a masked score (never -inf)

// 16 bytes from global to shared memory, asynchronously (L2 only); with
// `valid` false nothing is read and the 16 bytes are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
// 4 bytes likewise (through L1: the 4-byte form has no .cg); the lse and
// delta rows, whose starts are not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
// rows [r0, r0 + R) of one head of a (B, T, H, C::DH) float32 tensor into
// shared memory at row stride C::RS floats, by cp.async over C::THREADS
// threads; rows at or past T zero-filled (16-byte aligned rows: the
// wrappers check the strides)
template <class C, int R>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, long long st, int r0,
                                          int T) {
  constexpr int V4 = C::DH / 4;
  for (int idx = threadIdx.x; idx < R * V4; idx += C::THREADS) {
    const int r = idx / V4, c = 4 * (idx % V4);
    const bool valid = r0 + r < T;
    cp_async16(dst + r * C::RS + c, valid ? src + (long long)(r0 + r) * st + c : src, valid);
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x as hi = tf32(x) (round to nearest) and lo = x - hi (exact in float32),
// both as the 32-bit registers mma takes; the tensor cores read lo's top 19
// bits as a TF32 value (the rest ignored), so hi + lo carries 21 of x's 24
// bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d = A . B + d for one m16n8k8 tile with TF32 operands and float32 sums
// (A row-major 16 x 8, B column-major 8 x 8: the fragment layouts of the
// PTX manual); not volatile, so the compiler may interleave independent
// tiles
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A . B for one k step at float32 accuracy (3xTF32): the two small
// terms lo.hi and hi.lo first, then hi.hi, into the same accumulator
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

}  // namespace lss_f32
