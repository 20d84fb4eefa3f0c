// Tensor-core building blocks shared by the bf16 kernels of this package
// (flash_attention_tc.cu, ssd_scan_tc.cu; the float32 kernels take its
// cp.async helpers through tf32_mma.cuh, rg_lru_pipe.cu takes them
// directly): cp.async tile copies, ldmatrix
// fragment loads, the bf16 mma.sync.m16n8k16 with float32 accumulation,
// and the hi/lo split of float32 values into two bf16 operands.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major) a0: (g, 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)
//                        a3: (g+8, 2t+8..)
//   B (16x8, k x n)      b0: (k 2t..2t+1, n g)  b1: (k 2t+8..2t+9, n g)
//   C (16x8, float32)    c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..2t+1)
// The C fragments of two neighbouring n-tiles are, element for element,
// the A fragment of one 16-deep k-step: a score tile feeds the next
// product from registers.
//
// The split rule: x = hi + lo with hi = bf16(x) and lo = bf16(x - hi)
// keeps 16 of float32's 24 significand bits (|x - hi - lo| <= 2^-16 |x|
// about), so a product of a split float32 operand with an operand that is
// exact in bf16 costs two mma and stays within float32 rounding of the
// kernel's tolerance, where one bf16 rounding (2^-8 relative) does not.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when
// !valid (no byte is read then, and src only has to be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives it
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b: bf16 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// (x0, x1) -> bf16 pairs hi and lo, x0 in the low half (the lower column)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

}  // namespace tc
