// Tensor-core and asynchronous-copy helpers shared by the port's kernels
// (sm_90a): 16-byte and 4-byte cp.async with their commit/wait pair, and
// float32 products on the tensor cores as 3 x TF32 on mma.sync m16n8k8.
//
// m16n8k8 TF32 fragments, with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// A C fragment feeds the A operand of a following product without a
// shuffle when that product reads its k index t as column 2t and t + 4 as
// column 2t + 1 (and loads its B rows in the same order): the sum over k
// is the same.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when `bytes` is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
// 4 bytes global -> shared, zero-filled when `bytes` is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo with hi x rounded to TF32 (nearest, ties away from zero, as
// cvt.rna.tf32.f32) and lo = x - hi exact in float32.  lo goes to the
// tensor core with its low 13 bits left in place: the TF32 mma ignores
// them, which truncates lo to TF32 (relative error 2^-21 of x).  Three
// integer/float instructions where two cvt.rna would take more.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c += a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (small terms first)
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Split the four A values (a0..a3 order) and the two B values of one
// m16n8k8 step into TF32 hi/lo parts.
struct FragA {
  uint32_t h[4], l[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split_tf32(a0, h[0], l[0]);
    split_tf32(a1, h[1], l[1]);
    split_tf32(a2, h[2], l[2]);
    split_tf32(a3, h[3], l[3]);
  }
};
struct FragB {
  uint32_t h[2], l[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, h[0], l[0]);
    split_tf32(b1, h[1], l[1]);
  }
};
__device__ __forceinline__ void mma_3xtf32(float* c, const FragA& a,
                                           const FragB& b) {
  mma_3xtf32(c, a.h, a.l, b.h, b.l);
}

}  // namespace repro
