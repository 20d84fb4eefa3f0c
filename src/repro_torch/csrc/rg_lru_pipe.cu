// RG-LRU gated linear recurrence for Hopper (sm_90a), its inputs streamed
// through a ring of shared-memory stages by asynchronous copies.
//
// Replaces: rg_lru_tpu in src/repro/kernels/rg_lru.py, the Pallas kernel
// of the RecurrentGemma (Griffin) recurrence on the TPU.  In this package
// it runs the recurrence of every rglru layer's prefill; csrc/rg_lru.cu,
// the first design, stays as a comparator on no path.
//
// What it computes: a, gx (B,S,W), float32 or bf16, upcast to float32;
// per channel (b, w), from h = 0,
//   h_t = a_t * h_{t-1} + gx_t,   y[b, t, w] = h_t   (y float32).
// The product and the sum are rounded one at a time (__fmul_rn,
// __fadd_rn: never contracted into an FMA) and in the sequence's order, so
// the kernel rounds exactly as its plain version, `a_t * h + g_t` in two
// PyTorch operations, and matches it bit for bit.  A chunked or associative
// scan would round in another order (and read the inputs twice); the
// sequential walk costs little: 2 * S dependent operations a channel, about
// 16k cycles (9 us) at S 2000.
//
// Bound: bytes.  At one recurrentgemma-2b prefill layer (B 4, S 2000,
// W 2560, float32) a and gx are read and y written once: 3 x 81.92 MB =
// 245.8 MB, 0.073 ms at 3.35 TB/s; the 2*B*S*W = 41 MFLOP are nothing.
//
// Why the first design is slow: one thread a channel gives B*W = 10,240
// threads, and each issued its next 16 positions' loads only after the
// last 16 positions' updates, so the bytes in flight fell to zero once
// every 16 positions and stayed far below what the memory's latency needs
// (Little's law: 3.35 TB/s x about 1 us = 3.4 MB).  It was latency-bound.
//
// Design: still one thread a channel, kChannels neighbouring channels a CTA
// (160 CTAs at the prefill shape, all resident at once), h in a register.
// The CTA streams its channels' columns of a and gx through a ring of
// kStages stages in dynamic shared memory; a stage holds kStageBytes: the
// a and gx rows of kPos positions (32 float32 or 64 bf16 rows of
// kChannels).  Every thread copies its share of a stage with 16-byte
// cp.async.cg (neighbouring threads on neighbouring chunks of a row, so a
// warp's copies are whole lines), one commit group a stage, through
// running pointers: the CTA's two warps issue both the copies and the
// walk, so a copy costs a few instructions.  While stage k is consumed,
// stages k+1 .. k+kStages-1 are in flight: 32 KB a CTA, 5.1 MB over the
// card at the prefill shape (deeper rings and wider CTAs measured no
// faster on an H100; PERF.md keeps the record).  The consumer loads 16
// positions of its channel's column of the stage into registers (a thread
// a 4-byte bank: no conflicts; two bf16 a word are a broadcast), then runs
// their steps and stores y straight from registers (a warp's stores are
// one 128-byte line).  One __syncthreads a stage both makes the landed
// stage visible to every thread and frees the slot consumed last for the
// next copy.
//
// Alignment: the copies need 16-byte aligned rows and whole chunks.  Where
// the pointers, the batch and position strides and W allow that, the kernel
// is instantiated with VEC; otherwise (a column slice at an odd offset, W
// not a multiple of the chunk) with element-by-element copies into the
// same ring (16 rows' loads issued together, then their stores: no
// asynchronous copy moves 2 bytes, and no model path takes it).  The
// choice is made at launch, never inside the loop.  Ragged edges: copies
// past S or W are not issued, the last stage consumes only the positions
// below S, and a stage past the end commits an empty group, so the waits
// count the same groups to the end.  No atomics, one order of operations:
// two runs give the same bits.

#include "tc_mma.cuh"  // tc::cp_async16, tc::cp_async_commit, _wait

namespace {

constexpr int kChannels = 64;             // channels (threads) a CTA
constexpr int kStages = 3;                // stages in the ring
constexpr int kStageBytes = 16 * 1024;    // a stage's a and gx rows
constexpr size_t kSmem = static_cast<size_t>(kStages) * kStageBytes;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct Stage {
  static constexpr int kPos = kStageBytes / (2 * kChannels * sizeof(T));
  static constexpr int kElems = 16 / sizeof(T);          // a chunk
  static constexpr int kChunks = kChannels / kElems;     // a row
  static constexpr int kSize = 2 * kPos * kChannels;     // T a stage
  static_assert(kPos % 16 == 0 && kChannels % kElems == 0, "whole chunks");
};

struct Params {
  const void* a;
  const void* gx;
  float* y;
  int64_t a_sb, a_ss, g_sb, g_ss, y_sb, y_ss;
  int S, W;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kChannels)
rg_lru_pipe_kernel(const Params p) {
  using St = Stage<T>;
  // a thread's copies: with VEC the chunk of kElems channels from c in
  // rows r0, r0 + kElems, ... of a stage (neighbouring threads on
  // neighbouring chunks), else its own channel in every row
  constexpr int kStep = VEC ? St::kElems : 1;  // rows between its copies
  constexpr int kCopies = St::kPos / kStep;    // of a and of gx a stage
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int t = threadIdx.x;
  const int w0 = blockIdx.x * kChannels;
  const int64_t b = blockIdx.y;
  const int r0 = VEC ? t / St::kChunks : 0;
  const int c = VEC ? t % St::kChunks * St::kElems : t;
  const bool copies = w0 + c < p.W;
  const T* a0 =
      static_cast<const T*>(p.a) + b * p.a_sb + r0 * p.a_ss + w0 + c;
  const T* g0 =
      static_cast<const T*>(p.gx) + b * p.g_sb + r0 * p.g_ss + w0 + c;
  T* d0 = ring + r0 * kChannels + c;
  const int nstages = (p.S + St::kPos - 1) / St::kPos;

  // stage k into its slot; nothing at or past S or W.  The pointers run
  // (a few instructions a copy: the CTA's two warps issue both the copies
  // and the walk)
  auto load = [&](int k) {
    if (!copies) return;
    const int s0 = k * St::kPos;
    const int n = min(St::kPos, p.S - s0) - r0;  // rows from r0 below S
    const T* pa = a0 + s0 * p.a_ss;
    const T* pg = g0 + s0 * p.g_ss;
    T* d = d0 + (k % kStages) * St::kSize;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        if (i * kStep < n) {
          tc::cp_async16(d + i * kStep * kChannels, pa, true);
          tc::cp_async16(d + (St::kPos + i * kStep) * kChannels, pg, true);
        }
        pa += kStep * p.a_ss;
        pg += kStep * p.g_ss;
      }
    } else {  // 16 rows' loads issued together, then their stores
#pragma unroll
      for (int i0 = 0; i0 < kCopies; i0 += 16) {
        T va[16], vg[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (i0 + i < n) {
            va[i] = pa[(i0 + i) * p.a_ss];
            vg[i] = pg[(i0 + i) * p.g_ss];
          }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (i0 + i < n) {
            d[(i0 + i) * kChannels] = va[i];
            d[(St::kPos + i0 + i) * kChannels] = vg[i];
          }
        }
      }
    }
  };

  for (int k = 0; k < kStages - 1; ++k) {
    if (k < nstages) load(k);
    tc::cp_async_commit();
  }
  const bool live = w0 + t < p.W;
  float* yq = p.y + b * p.y_sb + w0 + t;  // y at the next position
  float h = 0.f;
  for (int k = 0; k < nstages; ++k) {
    tc::cp_async_wait<kStages - 2>();  // this thread's copies of stage k
    __syncthreads();  // everyone's, and stage k - 1 is consumed by all
    if (k + kStages - 1 < nstages) load(k + kStages - 1);
    tc::cp_async_commit();  // an empty group past the end
    if (!live) continue;
    const T* as = ring + (k % kStages) * St::kSize + t;
    const T* gs = as + St::kPos * kChannels;
    const int n = min(St::kPos, p.S - k * St::kPos);
    if (n == St::kPos) {
#pragma unroll
      for (int r0 = 0; r0 < St::kPos; r0 += 16) {
        // loaded ahead of the stores, which the compiler may not pass
        float av[16], gv[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          av[i] = to_f32(as[(r0 + i) * kChannels]);
          gv[i] = to_f32(gs[(r0 + i) * kChannels]);
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          h = __fadd_rn(__fmul_rn(av[i], h), gv[i]);
          *yq = h;
          yq += p.y_ss;
        }
      }
    } else {
      for (int r = 0; r < n; ++r) {
        h = __fadd_rn(__fmul_rn(to_f32(as[r * kChannels]), h),
                      to_f32(gs[r * kChannels]));
        *yq = h;
        yq += p.y_ss;
      }
    }
  }
}

template <typename T, bool VEC>
int launch_one(const Params& p, int64_t B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rg_lru_pipe_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.W + kChannels - 1) / kChannels),
                  static_cast<unsigned>(B));
  rg_lru_pipe_kernel<T, VEC><<<grid, kChannels, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Params& p, int64_t B, cudaStream_t stream) {
  // rows in whole, 16-byte aligned chunks of a and gx
  constexpr int64_t e = Stage<T>::kElems;
  const bool vec = reinterpret_cast<uintptr_t>(p.a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.gx) % 16 == 0 &&
                   p.a_sb % e == 0 && p.a_ss % e == 0 && p.g_sb % e == 0 &&
                   p.g_ss % e == 0 && p.W % e == 0;
  return vec ? launch_one<T, true>(p, B, stream)
             : launch_one<T, false>(p, B, stream);
}

}  // namespace

// y = rg_lru(a, gx) on `stream`.  Pointers are device pointers, strides are
// in elements (the last dimension of a, gx and y is contiguous); y is
// float32; bf16 != 0 selects __nv_bfloat16 for a and gx, else float.
// Returns cudaGetLastError() after the launch.
extern "C" int rg_lru_pipe_launch(const void* a, const void* gx, void* y,
                                  int64_t B, int64_t S, int64_t W,
                                  int64_t a_sb, int64_t a_ss, int64_t g_sb,
                                  int64_t g_ss, int64_t y_sb, int64_t y_ss,
                                  int64_t bf16, void* stream) {
  Params p;
  p.a = a;
  p.gx = gx;
  p.y = static_cast<float*>(y);
  p.a_sb = a_sb; p.a_ss = a_ss;
  p.g_sb = g_sb; p.g_ss = g_ss;
  p.y_sb = y_sb; p.y_ss = y_ss;
  p.S = static_cast<int>(S);
  p.W = static_cast<int>(W);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, B, st) : launch<float>(p, B, st);
}
