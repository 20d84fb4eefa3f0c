// RG-LRU gated linear recurrence for Hopper (sm_90a).
//
// Replaces: rg_lru_tpu in src/repro/kernels/rg_lru.py, the Pallas kernel
// of the RecurrentGemma (Griffin) recurrence on the TPU.  In this package
// it runs the recurrence of every rglru layer's prefill.
//
// What it computes: a, gx (B,S,W), float32 or bf16, upcast to float32;
// per channel (b, w), from h = 0,
//   h_t = a_t * h_{t-1} + gx_t,   y[b, t, w] = h_t   (y float32).
// gx is already sqrt(1 - a^2) * i * x; the gates are matrix products that
// run outside the kernel, as on the TPU.  The product and the sum are
// rounded one at a time (__fmul_rn, __fadd_rn: never contracted into an
// FMA), so the kernel rounds exactly as its plain version,
// `a_t * h + g_t` in two PyTorch operations, and matches it bit for bit.
//
// Bound: bytes.  At one recurrentgemma-2b prefill layer (B 4, S 2000,
// W 2560, float32) a and gx are read and y written once: 3 x 81.92 MB =
// 245.8 MB, 0.073 ms at 3.35 TB/s; the 2*B*S*W = 41 MFLOP are nothing.
//
// Design: the simple form first.  The TPU walks S in blocks of 256 on its
// sequential grid axis and carries h in VMEM scratch; here one thread owns
// one (b, w) channel and walks all of S itself with h in a register, so
// nothing carries between blocks.  Neighbouring threads own neighbouring
// w, so every load and store of a warp is one coalesced 128-byte line.
// The loads do not depend on h: each thread issues the next kUnroll
// positions' loads of a and gx before their dependent multiply-adds, which
// keeps kUnroll loads in flight per thread and hides most of the memory
// latency.  At the prefill shape that is B*W = 10,240 threads, one wave on
// 132 SMs (160 CTAs of 64), too few to fill the card's memory pipes; the
// chunked two-pass scan that fixes it (chunk-local scans in parallel, then
// the carried states) is later work.  a and gx are read through their
// batch and position strides (the last dimension contiguous); ragged S
// needs no padding, since the loop ends at S.  No atomics, one order of
// operations: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // channels per CTA
constexpr int kUnroll = 16;   // positions loaded ahead of their updates

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ gx,
              float* __restrict__ y, int S, int W, int64_t a_sb,
              int64_t a_ss, int64_t g_sb, int64_t g_ss, int64_t y_sb,
              int64_t y_ss) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int64_t b = blockIdx.y;
  const T* ap = a + b * a_sb + w;
  const T* gp = gx + b * g_sb + w;
  float* yp = y + b * y_sb + w;
  float h = 0.f;
  int s = 0;
  for (; s + kUnroll <= S; s += kUnroll) {
    float av[kUnroll], gv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = to_f32(ap[(s + i) * a_ss]);
      gv[i] = to_f32(gp[(s + i) * g_ss]);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), gv[i]);
      yp[(s + i) * y_ss] = h;
    }
  }
  for (; s < S; ++s) {
    h = __fadd_rn(__fmul_rn(to_f32(ap[s * a_ss]), h), to_f32(gp[s * g_ss]));
    yp[s * y_ss] = h;
  }
}

template <typename T>
int launch(const void* a, const void* gx, void* y, int64_t B, int64_t S,
           int64_t W, int64_t a_sb, int64_t a_ss, int64_t g_sb, int64_t g_ss,
           int64_t y_sb, int64_t y_ss, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  rg_lru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(gx),
      static_cast<float*>(y), static_cast<int>(S), static_cast<int>(W), a_sb,
      a_ss, g_sb, g_ss, y_sb, y_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = rg_lru(a, gx) on `stream`.  Pointers are device pointers, strides are
// in elements (the last dimension of a, gx and y is contiguous); y is
// float32; bf16 != 0 selects __nv_bfloat16 for a and gx, else float.
// Returns cudaGetLastError() after the launch.
extern "C" int rg_lru_launch(const void* a, const void* gx, void* y,
                             int64_t B, int64_t S, int64_t W, int64_t a_sb,
                             int64_t a_ss, int64_t g_sb, int64_t g_ss,
                             int64_t y_sb, int64_t y_ss, int64_t bf16,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(a, gx, y, B, S, W, a_sb, a_ss, g_sb, g_ss,
                                 y_sb, y_ss, st);
  }
  return launch<float>(a, gx, y, B, S, W, a_sb, a_ss, g_sb, g_ss, y_sb, y_ss,
                       st);
}
