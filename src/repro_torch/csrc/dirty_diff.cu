// Changed-page flags for device-side selective sync, for Hopper (sm_90a).
//
// Replaces: dirty_diff_tpu in src/repro/kernels/dirty_diff.py, the Pallas
// kernel behind Window.device_dirty_mask, the per-span sync route and the
// first pass of the fused diff+pack route.
//
// What it computes: cur and snap are two byte strings of total_bytes bytes,
// cut into blocks of block_bytes (one window page each; the last block may
// be short).  flags[b] = 1 iff block b differs anywhere.  The compare is on
// bytes, so it is the TPU kernel's bit-pattern compare for every dtype: an
// unchanged block of NaNs stays clean.
//
// Bound: memory.  Each input byte is read once (2*N bytes) and one int32 is
// written per block; there is no arithmetic worth counting, so on an H100
// the floor is 2*N / 3.35 TB/s.
//
// Design: the TPU kernel walks a sequential (block, tile) grid and ORs a
// flag that stays resident across tiles.  Here every block is one CTA, and
// the CTAs run in any order, since no state is carried between blocks.
// Each thread ORs the XOR of 16-byte vector loads (uint4, read-only path),
// so a 4 KiB page is one load pair per thread of a 256-thread CTA; then
// __syncthreads_or reduces the CTA and thread 0 stores the flag.  The
// vector path needs 16-byte aligned pointers and block size, which every
// page-sized block has; a byte loop in the same kernel covers the rest and
// the short last block, so the inputs are never padded or copied.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool differ16(uint4 a, uint4 b) {
  return ((a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w)) != 0u;
}

__global__ void __launch_bounds__(kThreads)
dirty_diff_kernel(const uint8_t* __restrict__ cur,
                  const uint8_t* __restrict__ snap,
                  int32_t* __restrict__ flags, int64_t block_bytes,
                  int64_t total_bytes, int vec) {
  const int64_t b = blockIdx.x;
  const int64_t lo = b * block_bytes;
  const int64_t rem = total_bytes - lo;
  const int64_t len = rem < block_bytes ? rem : block_bytes;
  bool any = false;
  int64_t done = 0;
  if (vec) {
    const uint4* c4 = reinterpret_cast<const uint4*>(cur + lo);
    const uint4* s4 = reinterpret_cast<const uint4*>(snap + lo);
    const int64_t n16 = len >> 4;
    for (int64_t j = threadIdx.x; j < n16; j += blockDim.x) {
      any |= differ16(__ldg(c4 + j), __ldg(s4 + j));
    }
    done = n16 << 4;
  }
  for (int64_t j = done + threadIdx.x; j < len; j += blockDim.x) {
    any |= __ldg(cur + lo + j) != __ldg(snap + lo + j);
  }
  const int dirty = __syncthreads_or(any);
  if (threadIdx.x == 0) flags[b] = dirty ? 1 : 0;
}

}  // namespace

// flags[0:nblocks] for the byte strings cur and snap (device pointers), on
// `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int dirty_diff_launch(const void* cur, const void* snap,
                                 void* flags, int64_t nblocks,
                                 int64_t block_bytes, int64_t total_bytes,
                                 void* stream) {
  const int vec = (reinterpret_cast<uintptr_t>(cur) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(snap) % 16 == 0) &&
                  (block_bytes % 16 == 0);
  dirty_diff_kernel<<<static_cast<unsigned int>(nblocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cur), static_cast<const uint8_t*>(snap),
      static_cast<int32_t*>(flags), block_bytes, total_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}
