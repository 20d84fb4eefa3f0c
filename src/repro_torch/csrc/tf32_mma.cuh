// Float32-accurate products on Hopper's tensor cores, shared by the
// float32 kernels of this package (flash_attention_tc32.cu,
// ssd_scan_tc32.cu): the TF32 mma.sync.m16n8k8 with float32 accumulation,
// and the split of a float32 value into two TF32 parts.
//
// Fragment layouts of mma.m16n8k8 with TF32 operands (g = lane / 4,
// t = lane % 4), one 32-bit register an element:
//   A (16x8, row-major) a0: (g, t)  a1: (g+8, t)  a2: (g, t+4)  a3: (g+8, t+4)
//   B (8x8, k x n)      b0: (k t, n g)  b1: (k t+4, n g)
//   C (16x8, float32)   c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..2t+1)
// C's columns are not A's k: a lane holds columns 2t and 2t+1 of a score
// tile, and A wants k = t and t+4 from it.  The order of a contraction is
// free, so a kernel that feeds a C tile to the next product as A (P.V)
// numbers its k by k = t <-> column 2t and k = t+4 <-> column 2t+1, and
// loads B's rows in that order: b0 from row 2t, b1 from row 2t+1.
//
// The split rule (3xTF32): x = hi + lo with hi = tf32(x) and lo = tf32(x -
// hi), both rounded to nearest with ties away from zero, keeps
// 22 of float32's 24 significand bits; a.b = ah.bh + ah.bl + al.bh drops
// only al.bl (2^-22 relative), so three TF32 products give a float32-
// accurate product at a third of the TF32 rate (495 / 3 = 165 TFLOP/s on an
// H100 SXM).  Each product of two TF32 values is exact in float32, and
// the small terms go in first.

#pragma once

#include "tc_mma.cuh"  // tc::cp_async16, tc::cp_async_commit, _wait

namespace tf32 {

// round to TF32 (10 explicit mantissa bits), nearest, ties away from zero:
// cvt.rna.tf32.f32's result for finite x, in two integer operations (the
// kernels round every operand element at each use, and a conversion
// instruction has a fraction of the integer units' throughput)
__device__ __forceinline__ uint32_t round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round(x);
  lo = round(x - __uint_as_float(hi));
}

// d += a * b: TF32 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment of four float32 values, split
struct A {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// d += a * (b0, b1) with float32 operands, in three TF32 products
__device__ __forceinline__ void mma3(float (&d)[4], const A& a, float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, a.lo, bh0, bh1);
  mma(d, a.hi, bl0, bl1);
  mma(d, a.hi, bh0, bh1);
}

// the same product with the large term hi.hi into `big` and the two small
// ones into `small`: two accumulator chains where mma3 has one
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const A& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(small, a.lo, bh0, bh1);
  mma(big, a.hi, bh0, bh1);
  mma(small, a.hi, bl0, bl1);
}

}  // namespace tf32
