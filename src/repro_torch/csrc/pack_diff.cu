// Compaction of the changed pages for device-side selective sync, for
// Hopper (sm_90a).
//
// Replaces: diff_pack_tpu in src/repro/kernels/pack_diff.py, the fused
// Pallas diff+pack kernel of the packed sync route (Window's default on
// the card).  Given the per-block flags of dirty_diff.cu (launched first by
// the same wrapper, on the same stream), it writes the changed blocks, in
// block order, to rows 0..count-1 of `packed`, and writes `count`.  Bytes of
// the short last block past the end of the input are zero in its row, as
// the reference's zero padding leaves them.  Rows from `count` on are not
// written.
//
// Bound: memory.  The whole diff+pack reads both inputs once (2*N bytes,
// in dirty_diff.cu) and writes the changed blocks once (d*N bytes for a
// changed fraction d); the flags and the scan move 4 bytes per block.  On
// an H100 the floor is (2 + d)*N / 3.35 TB/s.
//
// Design: the TPU kernel relies on a sequential grid: it streams every
// block into row `count` optimistically and claims the row when the block
// proves dirty.  GPU blocks run in parallel and in no order, so placement
// is computed first, in two passes on one stream: an exclusive scan of the
// flags over tiles of kTile flags (one 1024-thread CTA per tile, warp
// shuffles, then a scan of the warp totals), then one CTA scans the tile
// totals in place into tile offsets and writes `count`.  The copy kernel
// then gives every block one CTA; a clean block's CTA reads its flag and
// exits, a dirty one copies its bytes to row pos + tile offset with 16-byte
// loads and stores where the pointers and the block size allow it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kItems = 4;
constexpr int64_t kTile = kScanThreads * kItems;
constexpr int kCopyThreads = 256;

// Exclusive scan of one int per thread over the CTA; *total gets the sum.
// blockDim.x must be a multiple of 32.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nwarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int prefix = wid > 0 ? warp_sums[wid - 1] : 0;
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is reused by the caller's next round
  return prefix + x - v;
}

// pos[i] = number of set flags before i within i's tile;
// tile_sums[t] = number of set flags in tile t.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(const int32_t* __restrict__ flags, int32_t* __restrict__ pos,
                  int32_t* __restrict__ tile_sums, int64_t n) {
  const int64_t i0 = blockIdx.x * kTile + threadIdx.x * kItems;
  int f[kItems];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    f[k] = i0 + k < n ? flags[i0 + k] : 0;
    sum += f[k];
  }
  int total;
  int ex = block_exclusive_scan(sum, &total);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (i0 + k < n) pos[i0 + k] = ex;
    ex += f[k];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// In place: tile_sums[t] -> sum of tile_sums[0:t]; count[0] = the total.
// One CTA, looping over the tiles with a running carry.
__global__ void __launch_bounds__(kScanThreads)
scan_tile_sums_kernel(int32_t* __restrict__ tile_sums, int64_t ntiles,
                      int32_t* __restrict__ count) {
  int carry = 0;
  for (int64_t base = 0; base < ntiles; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    const int v = i < ntiles ? tile_sums[i] : 0;
    int total;
    const int ex = block_exclusive_scan(v, &total);
    if (i < ntiles) tile_sums[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) count[0] = carry;
}

__global__ void __launch_bounds__(kCopyThreads)
pack_rows_kernel(const uint8_t* __restrict__ cur,
                 const int32_t* __restrict__ flags,
                 const int32_t* __restrict__ pos,
                 const int32_t* __restrict__ tile_offs,
                 uint8_t* __restrict__ packed, int64_t block_bytes,
                 int64_t total_bytes, int vec) {
  const int64_t b = blockIdx.x;
  if (flags[b] == 0) return;
  const int64_t row = static_cast<int64_t>(pos[b]) + tile_offs[b / kTile];
  const int64_t lo = b * block_bytes;
  const int64_t rem = total_bytes - lo;
  const int64_t len = rem < block_bytes ? rem : block_bytes;
  const uint8_t* src = cur + lo;
  uint8_t* dst = packed + row * block_bytes;
  int64_t done = 0;
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const int64_t n16 = len >> 4;
    for (int64_t j = threadIdx.x; j < n16; j += blockDim.x) d4[j] = __ldg(s4 + j);
    done = n16 << 4;
  }
  for (int64_t j = done + threadIdx.x; j < len; j += blockDim.x) dst[j] = src[j];
  for (int64_t j = len + threadIdx.x; j < block_bytes; j += blockDim.x) dst[j] = 0;
}

}  // namespace

// Flags per scan tile: the wrapper sizes tile_offs as ceil(nblocks / tile).
extern "C" int64_t diff_pack_tile() { return kTile; }

// Scan of `flags` and compaction of the flagged blocks of `cur` into
// `packed` (nblocks rows of block_bytes), on `stream`.  `pos` (nblocks) and
// `tile_offs` (ceil(nblocks / kTile)) are scratch; `count` gets the number
// of packed rows.  Returns the first CUDA error of the three launches.
extern "C" int diff_pack_launch(const void* cur, const void* flags, void* pos,
                                void* tile_offs, void* count, void* packed,
                                int64_t nblocks, int64_t block_bytes,
                                int64_t total_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ntiles = (nblocks + kTile - 1) / kTile;
  scan_tiles_kernel<<<static_cast<unsigned int>(ntiles), kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(flags), static_cast<int32_t*>(pos),
      static_cast<int32_t*>(tile_offs), nblocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tile_sums_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<int32_t*>(tile_offs), ntiles, static_cast<int32_t*>(count));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (reinterpret_cast<uintptr_t>(cur) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(packed) % 16 == 0) &&
                  (block_bytes % 16 == 0);
  pack_rows_kernel<<<static_cast<unsigned int>(nblocks), kCopyThreads, 0, s>>>(
      static_cast<const uint8_t*>(cur), static_cast<const int32_t*>(flags),
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(tile_offs),
      static_cast<uint8_t*>(packed), block_bytes, total_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}
