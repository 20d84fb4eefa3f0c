// Mamba-2 SSD scan on Hopper's tensor cores, bf16 inputs (sm_90a).
//
// Replaces: ssd_scan_tpu in src/repro/kernels/ssd_scan.py for bf16 x, Bm
// and C (float32 inputs keep ssd_scan.cu, whose float32 products their
// limit needs).  In this package it runs the scan of every Mamba-2 layer's
// bf16 prefill.
//
// What it computes: x (B,H,S,P), dt (B,H,S) float32, A (H,) float32,
// Bm/C (B,H,S,N) bf16; with the (N,P) state h zero before the first
// position, per chunk of L positions: a = dt * A; cum = prefix sum of a;
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) (C_i . h_in);
//   h_out = exp(cum_last) h_in + sum_j (B_j exp(cum_last - cum_j) dt_j) (x) x_j.
// y is float32, and the state after the last position is a second output
// (B,H,N,P) float32 (the decode cache needs it; the TPU kernel drops it).
//
// Design: the state-passing decomposition of the identity the TPU kernel
// walks in order, in three launches on one stream:
//   (a) ssd_chunk_state: one CTA per (chunk, head, batch) computes cum and
//       the chunk-local state sum_j (B_j w_j dt_j) (x) x_j, with w_j =
//       exp(cum_last - cum_j), into a float32 scratch (B,H,nc,N,P), and
//       the chunk's decay exp(cum_last) into (B,H,nc);
//   (b) ssd_state_pass: one thread per four (batch, head, n, p) entries
//       walks the nc chunks in order, h_c = decay_c h_{c-1} + state_c,
//       writing the state that enters each chunk into a second scratch,
//       already split into bf16 hi and lo and laid out as (c)'s mma B
//       fragments (one 16-byte load a lane, no staging in shared memory),
//       and the last state to the state output;
//   (c) ssd_chunk_scan: one CTA per (chunk, head, batch) computes y from
//       its chunk and the state that enters it.
// The chunk length L is 64 (ssd_chunk.cuh says why); (a) and (c) run L / 16
// warps.  The chunks of (a) and (c), 32 a sequence of 2000 at L 64, run in
// parallel: 10,240 CTAs at mamba2-2.7b's prefill,
// not 320 sequential walks.  The products run on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, float32 accumulation) by the split
// rule of tc_mma.cuh: every
// float32 operand is split into bf16 hi + lo against an operand that is
// exact in bf16.  C.B^T: both bf16, one product, exact.  (scores * dt).x:
// the scores split, two products.  C.h_in: h_in split, two products, and
// exp(cum_i) applied to row i of the float32 result (exact, and cheaper
// than splitting C * exp(cum)).  The chunk state (B * w dt)^T . x: B * w dt
// split, two products.  With one bf16 rounding of those operands the
// chunked form misses the plain version by about 3e-3 per 256 positions
// (29x the limit of 1e-4); split, by about 5e-6 (tests/
// test_torch_tc_rounding.py emulates both).  exp(cum_i - cum_j) is taken
// only for i >= j, and only the score tiles on or below the diagonal are
// computed.  cum is a warp scan over the chunk, the same code in (a) and
// (c), so both see the same bits.  Ragged S: rows past S load as zeros
// with dt = 0, exact no-ops on the state.  Strides are arguments: x is
// read through the model's (B,S,H,P) view, Bm and C with a head stride of
// 0, y written in x's layout.  Rows that come in whole, aligned 16-byte
// chunks (the model's) are copied by cp.async, others element by element.
// N <= 128; P <= 64.  (a) and (c) are instantiated twice: with PAIRS (P
// even, y's rows 8-byte aligned: the model's) they store y and the chunk
// states a float2 at a time, without it one float at a time (an odd P).
// Every sum has a fixed order and there are no atomics: two runs give the
// same bits.  Shared with ssd_scan_tc32.cu (ssd_chunk.cuh): the chunk, the
// parameters, the row loads, cum, the stores and the launches.
//
// Bound: bytes.  At one mamba2-2.7b prefill layer (B 4, H 80, S 2000, P 64,
// N 128) the function's inputs and outputs are 262.9 MB, 0.0785 ms at 3.35
// TB/s.  This design also writes and reads its scratch: the chunk states
// are B*H*nc*N*P*4 = 335.5 MB (nc 32), written by (a) and read by (b), and
// their fragments (the same size at N 128, P 64) written by (b) and read
// by (c): 1.34 GB more, 0.40 ms at 3.35 TB/s.
//
// Resources (ptxas -v, sm_90a, CUDA 12.8), no spills: (a) 96 registers
// and 44,800 B of shared memory, 128 threads; (c) 106 registers and
// 44,544 B; (b) 72 registers, 256 threads, no shared memory.

#include "ssd_chunk.cuh"
#include "tc_mma.cuh"

namespace {

using ssd::kNMax;
using ssd::kPMax;
using ssd::L;
using tc::bf16;

constexpr int kLDN = kNMax + 8;  // bf16 rows padded by 16 bytes: ldmatrix
constexpr int kLDP = kPMax + 8;  // reads 8 rows without bank conflicts
// the state entering a chunk, as the B operand of C . h_in: one uint4 per
// lane for each 16-deep step over N and 8-wide tile over P, holding the
// lane's b0 and b1 of h_in's bf16 hi part, then of its lo part
constexpr int kKSteps = kNMax / 16;
constexpr int kPTiles = kPMax / 8;
constexpr int kFrags = kKSteps * kPTiles;

using Params = ssd::Params<bf16, uint4>;

// (a): the chunk-local state and decay.  L / 16 warps; each owns
// kNMax / (L / 16) state rows
template <bool PAIRS>
__global__ void __launch_bounds__(ssd::kThreads)
ssd_chunk_state(const Params p) {
  constexpr int kWarps = L / 16;
  constexpr int MT = kNMax / 16 / kWarps;  // 16-row tiles of a warp
  static_assert(MT * 16 * kWarps == kNMax, "whole state tiles per warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bh = reinterpret_cast<bf16*>(smem_raw);  // [L][kLDN] B, then hi
  bf16* Bl = Bh + L * kLDN;                       // [L][kLDN] lo
  bf16* Xs = Bl + L * kLDN;                       // [L][kLDP]
  float* dts = reinterpret_cast<float*>(Xs + L * kLDP);  // [L]
  float* cum = dts + L;                                   // [L]
  float* u = cum + L;                                     // [L]

  const int ci = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = ci * L;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lm = lane >> 3;
  const int lr = lane & 7;

  ssd::load_rows<kNMax, kLDN>(Bh, p.bm + b * p.b_sb + h * p.b_sh, p.b_ss,
                              s0, p.S, p.N, p.vec_b);
  ssd::load_rows<kPMax, kLDP>(Xs, p.x + b * p.x_sb + h * p.x_sh, p.x_ss, s0,
                              p.S, p.P, p.vec_x);
  tc::cp_async_commit();
  ssd::load_dt(dts, p, b, h, s0);
  __syncthreads();
  ssd::chunk_cum(dts, p.A[h], cum);
  __syncthreads();
  if (tid < L) u[tid] = expf(cum[L - 1] - cum[tid]) * dts[tid];
  if (tid == 0) {
    p.decay[(static_cast<int64_t>(b) * p.H + h) * p.nc + ci] =
        expf(cum[L - 1]);
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // B * (w dt), split in place: hi over B, lo beside it
  for (int idx = tid; idx < L * kNMax / 2; idx += ssd::kThreads) {
    const int r = idx / (kNMax / 2);
    const int n = (idx % (kNMax / 2)) * 2;
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<__nv_bfloat162*>(Bh + r * kLDN + n));
    uint32_t hi, lo;
    tc::split2(v.x * u[r], v.y * u[r], hi, lo);
    *reinterpret_cast<uint32_t*>(Bh + r * kLDN + n) = hi;
    *reinterpret_cast<uint32_t*>(Bl + r * kLDN + n) = lo;
  }
  __syncthreads();

  // state[n][p] = sum_j Bw[j][n] x[j][p]: M = N, N = P, K = the chunk's
  // positions; A = Bw^T from [j][n] storage (transposed)
  float acc[MT][kPMax / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kPMax / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int off = (kk * 16 + (lm >> 1) * 8 + lr) * kLDN +
                      (warp * MT + mt) * 16 + (lm & 1) * 8;
      tc::ldmatrix_x4_trans(ah[mt], Bh + off);
      tc::ldmatrix_x4_trans(al[mt], Bl + off);
    }
#pragma unroll
    for (int nt = 0; nt < kPMax / 8; nt += 2) {
      uint32_t xb[4];
      tc::ldmatrix_x4_trans(xb, Xs + (kk * 16 + (lm & 1) * 8 + lr) * kLDP +
                                    nt * 8 + (lm >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        tc::mma(acc[mt][nt], ah[mt], xb[0], xb[1]);
        tc::mma(acc[mt][nt], al[mt], xb[0], xb[1]);
        tc::mma(acc[mt][nt + 1], ah[mt], xb[2], xb[3]);
        tc::mma(acc[mt][nt + 1], al[mt], xb[2], xb[3]);
      }
    }
  }

  float* st = p.states +
              ((static_cast<int64_t>(b) * p.H + h) * p.nc + ci) * p.N * p.P;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = (warp * MT + mt) * 16 + g + 8 * i;
      if (n >= p.N) continue;
#pragma unroll
      for (int nt = 0; nt < kPMax / 8; ++nt) {
        ssd::store_pair<PAIRS>(st + n * p.P, nt * 8 + 2 * t, p.P,
                               acc[mt][nt][2 * i], acc[mt][nt][2 * i + 1]);
      }
    }
}

// (b): the state entering each chunk, written as (c)'s mma fragments
// split into bf16 hi and lo, and the final state.  One thread per (batch,
// head, 16-deep step over N, 8-wide tile over P, lane): it carries the four
// entries of h that the lane's fragment holds, (n, p) for n = 16 kk + 2t +
// {0, 1, 8, 9} and p = 8 nt + g, through the chunks in order.  Its loads of
// one chunk are four 32-byte sectors a warp, its stores 512 contiguous
// bytes.  The loads of kPassBatch chunks are issued before their stores
// (one memory round trip per batch, not per chunk)
constexpr int kPassBatch = 8;

__global__ void ssd_state_pass(const float* states, const float* decay,
                               uint4* hin, float* h_out, int nc, int N,
                               int P, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int lane = static_cast<int>(idx % 32);
  const int frag = static_cast<int>(idx / 32 % kFrags);
  const int64_t bh = idx / (32 * kFrags);
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col = (frag % kPTiles) * 8 + g;
  const int row0 = (frag / kPTiles) * 16 + 2 * t;
  const int rows[4] = {row0, row0 + 1, row0 + 8, row0 + 9};
  bool ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) ok[e] = rows[e] < N && col < P;
  const int64_t np = static_cast<int64_t>(N) * P;
  const float* st = states + bh * nc * np + col;
  const float* dc = decay + bh * nc;
  uint4* out = hin + bh * nc * (32 * kFrags) + frag * 32 + lane;
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float sv[kPassBatch][4], d[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      if (c0 + j < nc) {
        d[j] = dc[c0 + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sv[j][e] = ok[e] ? st[(c0 + j) * np + rows[e] * P] : 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      if (c0 + j < nc) {
        uint4 f;
        tc::split2(h[0], h[1], f.x, f.z);
        tc::split2(h[2], h[3], f.y, f.w);
        out[(c0 + j) * (32 * kFrags)] = f;
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = d[j] * h[e] + sv[j][e];
      }
    }
  }
  float* ho = h_out + bh * np + col;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (ok[e]) ho[rows[e] * P] = h[e];
  }
}

// (c): y of one chunk from its inputs and the state that enters it; L / 16
// warps, each owning 16 rows of the chunk
template <bool PAIRS>
__global__ void __launch_bounds__(ssd::kThreads)
ssd_chunk_scan(const Params p) {
  constexpr int NT = L / 8;      // 8-wide tiles of the score band
  constexpr int PT = kPMax / 8;  // 8-wide tiles of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // [L][kLDN]
  bf16* Bs = Cs + L * kLDN;                       // [L][kLDN]
  bf16* Xs = Bs + L * kLDN;                       // [L][kLDP]
  float* dts = reinterpret_cast<float*>(Xs + L * kLDP);  // [L]
  float* cum = dts + L;                                   // [L]

  const int ci = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = ci * L;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lm = lane >> 3;
  const int lr = lane & 7;
  const bool carried = ci > 0;  // the state entering chunk 0 is zero

  ssd::load_rows<kNMax, kLDN>(Cs, p.c + b * p.c_sb + h * p.c_sh, p.c_ss, s0,
                              p.S, p.N, p.vec_c);
  ssd::load_rows<kNMax, kLDN>(Bs, p.bm + b * p.b_sb + h * p.b_sh, p.b_ss,
                              s0, p.S, p.N, p.vec_b);
  ssd::load_rows<kPMax, kLDP>(Xs, p.x + b * p.x_sb + h * p.x_sh, p.x_ss, s0,
                              p.S, p.P, p.vec_x);
  tc::cp_async_commit();
  ssd::load_dt(dts, p, b, h, s0);
  __syncthreads();
  ssd::chunk_cum(dts, p.A[h], cum);
  tc::cp_async_wait<0>();
  __syncthreads();

  const int r_lo = warp * 16 + g;  // this thread's two rows of the chunk
  const int r_hi = r_lo + 8;
  const uint4* hf =
      p.hin + ((static_cast<int64_t>(b) * p.H + h) * p.nc + ci) * 32 * kFrags +
      lane;

  // one pass over n: ych = C . h_in (split h_in) and G = C . B^T for the
  // score tiles on or below the diagonal (j < 16 warp + 16)
  float ych[PT][4], gs[NT][4];
#pragma unroll
  for (int nt = 0; nt < PT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ych[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) gs[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kNMax / 16; ++kk) {
    uint32_t a[4];
    tc::ldmatrix_x4(a, Cs + (warp * 16 + (lane & 15)) * kLDN + kk * 16 +
                           (lane >> 4) * 8);
    if (carried) {  // h_in's fragments straight from (b), hi then lo
#pragma unroll
      for (int nt = 0; nt < PT; ++nt) {
        const uint4 f = hf[(kk * kPTiles + nt) * 32];
        tc::mma(ych[nt], a, f.x, f.y);
        tc::mma(ych[nt], a, f.z, f.w);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      if (nt / 2 > warp) continue;  // wholly above the diagonal
      uint32_t bb[4];  // B rows are the columns j: no transpose
      tc::ldmatrix_x4(bb, Bs + (nt * 8 + (lm >> 1) * 8 + lr) * kLDN +
                              kk * 16 + (lm & 1) * 8);
      tc::mma(gs[nt], a, bb[0], bb[1]);
      tc::mma(gs[nt + 1], a, bb[2], bb[3]);
    }
  }

  // y = exp(cum_i) ych + (G * decay * dt) . x, the scores split
  const float e_lo = expf(cum[r_lo]);
  const float e_hi = expf(cum[r_hi]);
#pragma unroll
  for (int nt = 0; nt < PT; ++nt) {
    ych[nt][0] *= e_lo;
    ych[nt][1] *= e_lo;
    ych[nt][2] *= e_hi;
    ych[nt][3] *= e_hi;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt / 2 > warp) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? r_lo : r_hi;
      const int j = nt * 8 + 2 * t + (e & 1);
      gs[nt][e] = j <= i ? gs[nt][e] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk) {
    if (kk > warp) continue;
    uint32_t sh[4], sl[4];
    tc::split2(gs[2 * kk][0], gs[2 * kk][1], sh[0], sl[0]);
    tc::split2(gs[2 * kk][2], gs[2 * kk][3], sh[1], sl[1]);
    tc::split2(gs[2 * kk + 1][0], gs[2 * kk + 1][1], sh[2], sl[2]);
    tc::split2(gs[2 * kk + 1][2], gs[2 * kk + 1][3], sh[3], sl[3]);
#pragma unroll
    for (int nt = 0; nt < PT; nt += 2) {
      uint32_t xb[4];
      tc::ldmatrix_x4_trans(xb, Xs + (kk * 16 + (lm & 1) * 8 + lr) * kLDP +
                                    nt * 8 + (lm >> 1) * 8);
      tc::mma(ych[nt], sh, xb[0], xb[1]);
      tc::mma(ych[nt], sl, xb[0], xb[1]);
      tc::mma(ych[nt + 1], sh, xb[2], xb[3]);
      tc::mma(ych[nt + 1], sl, xb[2], xb[3]);
    }
  }

  float* yp = p.y + b * p.y_sb + h * p.y_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = s0 + (i ? r_hi : r_lo);
    if (r >= p.S) continue;
    float* yrow = yp + static_cast<int64_t>(r) * p.y_ss;
#pragma unroll
    for (int nt = 0; nt < PT; ++nt) {
      ssd::store_pair<PAIRS>(yrow, nt * 8 + 2 * t, p.P, ych[nt][2 * i],
                             ych[nt][2 * i + 1]);
    }
  }
}

constexpr size_t kSmemState =
    sizeof(bf16) * (2 * L * kLDN + L * kLDP) + sizeof(float) * 3 * L;
constexpr size_t kSmemScan =
    sizeof(bf16) * (2 * L * kLDN + L * kLDP) + sizeof(float) * 2 * L;

}  // namespace

// y, h_out = ssd_scan(x, dt, A, bm, c) on `stream`, in three launches, at
// L positions a chunk.  Pointers are device pointers (x,
// bm, c bf16; dt and A float32); strides are in elements; y is float32
// with its last dimension contiguous; h_out (B,H,N,P), states
// (B,H,nc,N,P), hin (B,H,nc,128*64, 16-byte aligned) and decay (B,H,nc)
// are contiguous float32 buffers, nc = ceil(S / L).  N <= 128; P <= 64.
// Returns the first CUDA error, or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int ssd_scan_tc_launch(
    const void* x, const void* dt, const void* A, const void* bm,
    const void* c, void* y, void* h_out, void* states, void* hin,
    void* decay,
    int64_t B, int64_t H, int64_t S, int64_t N, int64_t P, int64_t x_sb,
    int64_t x_sh, int64_t x_ss, int64_t dt_sb, int64_t dt_sh, int64_t dt_ss,
    int64_t b_sb, int64_t b_sh, int64_t b_ss, int64_t c_sb, int64_t c_sh,
    int64_t c_ss, int64_t y_sb, int64_t y_sh, int64_t y_ss,
    void* stream) {
  Params p;
  const int err = ssd::fill(p, x, dt, A, bm, c, y, h_out, states, hin,
                            decay, H, S, N, P, x_sb, x_sh, x_ss, dt_sb,
                            dt_sh, dt_ss, b_sb, b_sh, b_ss, c_sb, c_sh, c_ss,
                            y_sb, y_sh, y_ss);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.pairs
             ? ssd::launch(ssd_chunk_state<true>, ssd_state_pass,
                           ssd_chunk_scan<true>, kSmemState, kSmemScan,
                           kFrags, p, B, st)
             : ssd::launch(ssd_chunk_state<false>, ssd_state_pass,
                           ssd_chunk_scan<false>, kSmemState, kSmemScan,
                           kFrags, p, B, st);
}
