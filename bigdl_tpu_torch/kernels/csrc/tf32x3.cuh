// The fp32-on-TF32 machinery shared by the tensor-core kernels
// (flash_attention.cu's K2, cut_cross_entropy.cu's K3b and K3c): cp.async
// copies, the 3xTF32 operand split, ldmatrix fragment loads and the
// mma.sync m16n8k8 TF32 MMA.
//
// 3xTF32 is the error-compensated split CUTLASS calls
// OpMultiplyAddFastF32: a = hi + lo with hi = a rounded toward zero to
// TF32 and lo = the rest rounded to nearest, and a b ~ hi hi' + hi lo' +
// lo hi'. It keeps a product within a few 1e-6 of its fp32 value where a
// single TF32 product moves it by ~4e-4.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr uint32_t TF32_MASK = 0xffffe000u;   // sign, exponent, 10 bits

// x rounded to TF32 to nearest (ties away from zero), as fp32 bits.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & TF32_MASK;
}

// x = hi + lo, both TF32: hi is x rounded toward zero, lo the rest
// rounded to nearest (CUTLASS's FastF32 split: round_toward_zero big,
// round_half_ulp_truncate small).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & TF32_MASK;
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// x with its lo part pre-rounded, so that split_exact gives the same hi
// and lo with two operations: hi + lo is exact in fp32 (lo's bits lie
// within x's 23).
__device__ __forceinline__ float presplit(float x) {
  uint32_t hi, lo;
  split(x, hi, lo);
  return __fadd_rn(__uint_as_float(hi), __uint_as_float(lo));
}

__device__ __forceinline__ void split_exact(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x) & TF32_MASK;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// Four 8 x 4 fp32 matrices from shared memory, each lane giving the
// address of one 16-byte row (lanes 8i to 8i + 7: matrix i); lane t
// receives (row t / 4, column t % 4) of each, the TF32 fragment layout.
__device__ __forceinline__ void ldsm4(const float* row, uint32_t (&r)[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, a = ah + al and b = bh + bl, al bl dropped; the
// small terms first.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

}  // namespace
