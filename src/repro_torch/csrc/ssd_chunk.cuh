// What the chunk-parallel SSD scans share (ssd_scan_tc.cu for bf16 inputs,
// ssd_scan_tc32.cu for float32): the chunk and block sizes, the launch's
// parameters, a chunk's rows, its dt and its prefix sum of dt * A (computed
// in one order by every pass that needs it), the stores of y and of the
// chunk states, and the three launches.  Each scan keeps its own passes:
// they differ in the element type and the mma fragments.

#pragma once

#include "tc_mma.cuh"  // tc::cp_async16, tc::bf16

namespace ssd {

// L positions a chunk.  L 128 halves the scratch and (b), but (c) then runs
// twice the warps over the same h_in fragments and takes about twice as
// long; on an H100 the whole bf16 scan was slower at L 128, so L is 64
constexpr int L = 64;
constexpr int kThreads = 2 * L;  // (a) and (c): 4 warps, 16 rows each in (c)
constexpr int kNMax = 128;       // largest state size N
constexpr int kPMax = 64;        // largest head dimension P

// T: the element type of x, Bm and C; Frag: one lane's share of an mma B
// fragment of the state entering a chunk, as (b) writes it for (c)
template <class T, class Frag>
struct Params {
  const T* x;
  const float* dt;
  const float* A;
  const T* bm;
  const T* c;
  float* y;
  float* h_out;   // (B, H, N, P), contiguous
  float* states;  // (B, H, nc, N, P), contiguous scratch
  Frag* hin;      // (B, H, nc, fragments, 32): h_in as (c)'s B fragments
  float* decay;   // (B, H, nc), contiguous scratch
  int64_t x_sb, x_sh, x_ss;  // element strides: batch, head, position
  int64_t dt_sb, dt_sh, dt_ss;
  int64_t b_sb, b_sh, b_ss;
  int64_t c_sb, c_sh, c_ss;
  int64_t y_sb, y_sh, y_ss;
  int H, S, N, P, nc;
  bool vec_x, vec_b, vec_c;  // rows in whole, aligned 16-byte chunks
  bool pairs;  // P even and y's rows 8-byte aligned: the PAIRS kernels
};

template <class T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ tc::bf16 zero<tc::bf16>() {
  return __float2bfloat16(0.f);
}

// L rows of width `width` (at most W) from row0 into dst[L][LDW]; rows at
// or past S and columns at or past width are zeros.  By cp.async in
// 16-byte chunks where `vec` (width a whole number of chunks, rows 16-byte
// aligned), else element by element
template <int W, int LDW, class T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t ss,
                                          int row0, int S, int width,
                                          bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements a chunk
    constexpr int kChunks = W / E;
    static_assert(L * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
    for (int it = 0; it < L * kChunks / kThreads; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * E;
      const bool ok = row0 + r < S && c < width;
      const T* g = ok ? src + static_cast<int64_t>(row0 + r) * ss + c : src;
      tc::cp_async16(dst + r * LDW + c, g, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < L * W; idx += kThreads) {
    const int r = idx / W;
    const int c = idx % W;
    dst[r * LDW + c] = row0 + r < S && c < width
                           ? src[static_cast<int64_t>(row0 + r) * ss + c]
                           : zero<T>();
  }
}

// cum[r] = sum_{r' <= r} dts[r'] * A by warp 0 (L / 32 rows a lane in
// order, then a shuffle scan over the lanes): the same order in (a) and (c)
__device__ __forceinline__ void chunk_cum(const float* dts, float A,
                                          float* cum) {
  constexpr int E = L / 32;
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float loc[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += dts[E * lane + e] * A;
    loc[e] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  float ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) cum[E * lane + e] = ex + loc[e];
}

// dts[r] = dt at position s0 + r of (batch b, head h), by the first L
// threads; positions past S read as 0, an exact no-op step
template <class Prm>
__device__ __forceinline__ void load_dt(float* dts, const Prm& p, int b,
                                        int h, int s0) {
  if (threadIdx.x < L) {
    const int r = threadIdx.x;
    dts[r] = s0 + r < p.S ? p.dt[b * p.dt_sb + h * p.dt_sh +
                                 static_cast<int64_t>(s0 + r) * p.dt_ss]
                          : 0.f;
  }
}

// row[col], row[col + 1] = v0, v1, each where it is below P: one float2
// where PAIRS (P even, the row 8-byte aligned), else one float at a time
template <bool PAIRS>
__device__ __forceinline__ void store_pair(float* row, int col, int P,
                                           float v0, float v1) {
  if constexpr (PAIRS) {
    if (col < P) *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < P) row[col] = v0;
    if (col + 1 < P) row[col + 1] = v1;
  }
}

// rows of `width` elements of T in whole, 16-byte aligned chunks
template <class T>
inline bool vec16(const void* ptr, int64_t sb, int64_t sh, int64_t ss,
                  int64_t width) {
  constexpr int64_t E = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % E == 0 &&
         sh % E == 0 && ss % E == 0 && width % E == 0;
}

// p from the launch's arguments (see the scans' extern "C" functions);
// cudaErrorInvalidValue for a shape the kernels do not take
template <class T, class Frag>
int fill(Params<T, Frag>& p, const void* x, const void* dt, const void* A,
         const void* bm, const void* c, void* y, void* h_out, void* states,
         void* hin, void* decay, int64_t H, int64_t S, int64_t N, int64_t P,
         int64_t x_sb, int64_t x_sh, int64_t x_ss, int64_t dt_sb,
         int64_t dt_sh, int64_t dt_ss, int64_t b_sb, int64_t b_sh,
         int64_t b_ss, int64_t c_sb, int64_t c_sh, int64_t c_ss,
         int64_t y_sb, int64_t y_sh, int64_t y_ss) {
  if (N < 1 || N > kNMax || P < 1 || P > kPMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.x = static_cast<const T*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.bm = static_cast<const T*>(bm);
  p.c = static_cast<const T*>(c);
  p.y = static_cast<float*>(y);
  p.h_out = static_cast<float*>(h_out);
  p.states = static_cast<float*>(states);
  p.hin = static_cast<Frag*>(hin);
  p.decay = static_cast<float*>(decay);
  p.x_sb = x_sb; p.x_sh = x_sh; p.x_ss = x_ss;
  p.dt_sb = dt_sb; p.dt_sh = dt_sh; p.dt_ss = dt_ss;
  p.b_sb = b_sb; p.b_sh = b_sh; p.b_ss = b_ss;
  p.c_sb = c_sb; p.c_sh = c_sh; p.c_ss = c_ss;
  p.y_sb = y_sb; p.y_sh = y_sh; p.y_ss = y_ss;
  p.H = static_cast<int>(H);
  p.S = static_cast<int>(S);
  p.N = static_cast<int>(N);
  p.P = static_cast<int>(P);
  p.nc = static_cast<int>((S + L - 1) / L);
  p.vec_x = vec16<T>(x, x_sb, x_sh, x_ss, P);
  p.vec_b = vec16<T>(bm, b_sb, b_sh, b_ss, N);
  p.vec_c = vec16<T>(c, c_sb, c_sh, c_ss, N);
  p.pairs = reinterpret_cast<uintptr_t>(y) % 8 == 0 && P % 2 == 0 &&
            y_sb % 2 == 0 && y_sh % 2 == 0 && y_ss % 2 == 0;
  return 0;
}

// The pass over the chunks in order: (states, decay, hin, h_out, nc, N, P,
// threads in all)
template <class Frag>
using StatePass = void (*)(const float*, const float*, Frag*, float*, int,
                           int, int, int64_t);

// (a), (b) and (c) on one stream: (a) and (c) one CTA of kThreads per
// (chunk, head, batch) with smem_state / smem_scan bytes of shared memory,
// (b) one thread per lane of each of the `frags` fragments of h_in a
// (batch, head)
template <class Prm, class Frag>
int launch(void (*state)(Prm), StatePass<Frag> pass, void (*scan)(Prm),
           size_t smem_state, size_t smem_scan, int frags, const Prm& p,
           int64_t B, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      state, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_state));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(scan,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_scan));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(p.nc), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(B));
  state<<<grid, kThreads, smem_state, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = B * p.H * 32 * frags;
  constexpr int kPassThreads = 256;
  pass<<<static_cast<unsigned>((total + kPassThreads - 1) / kPassThreads),
         kPassThreads, 0, st>>>(p.states, p.decay, p.hin, p.h_out, p.nc,
                                p.N, p.P, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan<<<grid, kThreads, smem_scan, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd
