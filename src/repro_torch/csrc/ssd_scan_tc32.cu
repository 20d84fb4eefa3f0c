// Mamba-2 SSD scan on Hopper's tensor cores, float32 inputs (sm_90a).
//
// Replaces: ssd_scan_tpu in src/repro/kernels/ssd_scan.py for float32 x,
// Bm and C (bf16 inputs go to ssd_scan_tc.cu).  In this package it runs the
// scan of the float32 consistency gate's prefills, and of any Mamba-2
// served with dtype float32.
//
// What it computes: x (B,H,S,P), dt (B,H,S), A (H,), Bm/C (B,H,S,N), all
// float32; with the (N,P) state h zero before the first position, per
// chunk of L positions: a = dt * A; cum = prefix sum of a;
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//         + exp(cum_i) (C_i . h_in);
//   h_out = exp(cum_last) h_in + sum_j (B_j exp(cum_last - cum_j) dt_j) (x) x_j.
// y is float32, and the state after the last position is a second output
// (B,H,N,P) float32 (the decode cache needs it; the TPU kernel drops it).
//
// Design: ssd_scan_tc.cu's three launches on one stream, with float32
// operands:
//   (a) ssd_chunk_state32: one CTA per (chunk, head, batch): cum, the
//       chunk-local state sum_j (B_j u_j) (x) x_j with u_j = exp(cum_last -
//       cum_j) dt_j, into a float32 scratch (B,H,nc,N,P), and the chunk's
//       decay exp(cum_last) into (B,H,nc);
//   (b) ssd_state_pass32: one thread per two (batch, head, n, p) entries
//       walks the chunks in order, h_c = decay_c h_{c-1} + state_c, and
//       writes the state entering each chunk as (c)'s B fragments (one
//       float2 a lane), and the last state to the state output;
//   (c) ssd_chunk_scan32: one CTA per (chunk, head, batch): y from its
//       chunk and the state that enters it.
// The chunks of (a) and (c) run in parallel: 10,240 CTAs at mamba2-2.7b's
// prefill (B 4, H 80, 32 chunks of 64).  Every product has two float32
// operands and runs as a float32-accurate product on the tensor cores,
// three TF32 mma.sync.m16n8k8 (tf32_mma.cuh): C.B^T, (scores dt).x, C.h_in
// (exp(cum_i) applied to row i of the float32 result) and (B u)^T.x.  One
// TF32 rounding of those operands misses the plain version by far more
// than 1e-4 per 256 positions (tests/test_torch_tc32_rounding.py emulates
// both).  Shared memory holds each float32 value once and the split into
// TF32 hi and lo happens at the fragment load; row pitches are chosen so a
// warp's scalar fragment loads hit 32 banks (a pitch of 8 mod 32 words
// where lane (g, t) reads row t, column g; 4 mod 32 where it reads row g,
// column t, or rows 2t and 2t+1).  exp(cum_i - cum_j) is taken only for i
// >= j, and only the score tiles on or below the diagonal are computed.
// cum is a warp scan over the chunk, the same code in (a) and (c), so both
// see the same bits.  Ragged S: rows past S load as zeros with dt = 0,
// exact no-ops on the state.  Strides are arguments: x is read through the
// model's (B,S,H,P) view, Bm and C with a head stride of 0, y written in
// x's layout.  Rows in whole, aligned 16-byte chunks (the model's) are
// copied by cp.async, others element by element.  N <= 128, P <= 64; (a)
// and (c) are instantiated with and without PAIRS, as in ssd_scan_tc.cu,
// whose chunk, parameters, row loads, cum, stores and launches this file
// shares (ssd_chunk.cuh).  Every sum has a fixed order and there are no
// atomics: two runs give the same bits.
//
// Bound: at one mamba2-2.7b prefill layer (B 4, H 80, S 2000, P 64, N
// 128) the function's float32 inputs and outputs are 348.9 MB, 0.104 ms at
// 3.35 TB/s, and its 28.9 GFLOP 0.175 ms at 165 TFLOP/s (float32-accurate
// tensor-core products): operations.  This design also writes and reads
// its scratch: the chunk states (335.5 MB, nc 32), written by (a) and read
// by (b), and the entering states (the same size) written by (b) and read
// by (c): 1.34 GB more, 0.40 ms at 3.35 TB/s; and (a) and (c) both read x.
//
// Resources (ptxas -v, sm_90a, CUDA 12.8), no spills, 128 threads: (a) 95
// registers and 54,016 B of shared memory, (c) 100 registers and 85,504 B
// (two CTAs an SM); (b) 80 registers, 256 threads, no shared memory.

#include "ssd_chunk.cuh"
#include "tf32_mma.cuh"

namespace {

using ssd::kNMax;
using ssd::kPMax;
using ssd::kThreads;
using ssd::L;

// row pitches in floats: lane (g, t) reading row t, column g wants a pitch
// of 8 mod 32; reading row g, column t (or rows 2t, 2t + 1) 4 mod 32
constexpr int kLDBa = kNMax + 8;  // (a): B as A^T
constexpr int kLDXa = kPMax + 8;  // (a): x as B
constexpr int kLDNc = kNMax + 4;  // (c): C as A, B as B^T
constexpr int kLDXc = kPMax + 4;  // (c): x as B in the order of P's keys
// the state entering a chunk, as the B operand of C . h_in: one float2 per
// lane for each 8-deep step over N and 8-wide tile over P, holding the
// lane's b0 = h[8 kk + t][8 nt + g] and b1 = h[8 kk + t + 4][8 nt + g]
constexpr int kKSteps = kNMax / 8;
constexpr int kPTiles = kPMax / 8;
constexpr int kFrags = kKSteps * kPTiles;

using Params = ssd::Params<float, float2>;

// (a): the chunk-local state and decay.  4 warps; each owns 32 state rows
template <bool PAIRS>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state32(const Params p) {
  constexpr int MT = kNMax / 16 / 4;  // 16-row tiles of a warp
  constexpr int PT = kPMax / 8;
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;              // [L][kLDBa] B, then B * u
  float* Xs = Bs + L * kLDBa;    // [L][kLDXa]
  float* dts = Xs + L * kLDXa;   // [L]
  float* cum = dts + L;          // [L]
  float* u = cum + L;            // [L]

  const int ci = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = ci * L;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  ssd::load_rows<kNMax, kLDBa>(Bs, p.bm + b * p.b_sb + h * p.b_sh, p.b_ss, s0,
                               p.S, p.N, p.vec_b);
  ssd::load_rows<kPMax, kLDXa>(Xs, p.x + b * p.x_sb + h * p.x_sh, p.x_ss, s0,
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
  for (int idx = tid; idx < L * kNMax; idx += kThreads) {
    const int r = idx / kNMax;
    Bs[r * kLDBa + idx % kNMax] *= u[r];
  }
  __syncthreads();

  // state[n][p] = sum_j Bu[j][n] x[j][p]: M = N, N = P, K = the chunk's
  // positions; A = Bu^T read from [j][n] storage
  float acc[MT][PT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < PT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < L / 8; ++kk) {
    const float* br = Bs + (kk * 8 + t) * kLDBa + warp * MT * 16 + g;
    const float* xr = Xs + (kk * 8 + t) * kLDXa + g;
    tf32::A a[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* q = br + mt * 16;
      a[mt].set(q[0], q[8], q[4 * kLDBa], q[4 * kLDBa + 8]);
    }
#pragma unroll
    for (int nt = 0; nt < PT; ++nt) {
      const float b0 = xr[nt * 8];
      const float b1 = xr[nt * 8 + 4 * kLDXa];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) tf32::mma3(acc[mt][nt], a[mt], b0, b1);
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
      for (int nt = 0; nt < PT; ++nt) {
        ssd::store_pair<PAIRS>(st + n * p.P, nt * 8 + 2 * t, p.P,
                               acc[mt][nt][2 * i], acc[mt][nt][2 * i + 1]);
      }
    }
}

// (b): the state entering each chunk, written as (c)'s mma B fragments,
// and the final state.  One thread per (batch, head, 8-deep step over N,
// 8-wide tile over P, lane): it carries the two entries of h that the
// lane's fragment holds, (n, p) for n = 8 kk + t + {0, 4} and p = 8 nt + g,
// through the chunks in order.  The loads of kPassBatch chunks are issued
// before their stores (one memory round trip per batch, not per chunk)
constexpr int kPassBatch = 8;

__global__ void ssd_state_pass32(const float* states, const float* decay,
                                 float2* hin, float* h_out, int nc, int N,
                                 int P, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int lane = static_cast<int>(idx % 32);
  const int frag = static_cast<int>(idx / 32 % kFrags);
  const int64_t bh = idx / (32 * kFrags);
  const int col = (frag % kPTiles) * 8 + (lane >> 2);
  const int row0 = (frag / kPTiles) * 8 + (lane & 3);
  const int rows[2] = {row0, row0 + 4};
  bool ok[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) ok[e] = rows[e] < N && col < P;
  const int64_t np = static_cast<int64_t>(N) * P;
  const float* st = states + bh * nc * np + col;
  const float* dc = decay + bh * nc;
  float2* out = hin + bh * nc * (32 * kFrags) + frag * 32 + lane;
  float h[2] = {0.f, 0.f};
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float sv[kPassBatch][2], d[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      if (c0 + j < nc) {
        d[j] = dc[c0 + j];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sv[j][e] = ok[e] ? st[(c0 + j) * np + rows[e] * P] : 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      if (c0 + j < nc) {
        out[(c0 + j) * (32 * kFrags)] = make_float2(h[0], h[1]);
#pragma unroll
        for (int e = 0; e < 2; ++e) h[e] = d[j] * h[e] + sv[j][e];
      }
    }
  }
  float* ho = h_out + bh * np + col;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (ok[e]) ho[rows[e] * P] = h[e];
  }
}

// (c): y of one chunk from its inputs and the state that enters it; 4
// warps, each owning 16 rows of the chunk
template <bool PAIRS>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan32(const Params p) {
  constexpr int NT = L / 8;      // 8-wide tiles of the score band
  constexpr int PT = kPMax / 8;  // 8-wide tiles of y
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;             // [L][kLDNc]
  float* Bs = Cs + L * kLDNc;   // [L][kLDNc]
  float* Xs = Bs + L * kLDNc;   // [L][kLDXc]
  float* dts = Xs + L * kLDXc;  // [L]
  float* cum = dts + L;         // [L]

  const int ci = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = ci * L;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  ssd::load_rows<kNMax, kLDNc>(Cs, p.c + b * p.c_sb + h * p.c_sh, p.c_ss, s0,
                               p.S, p.N, p.vec_c);
  ssd::load_rows<kNMax, kLDNc>(Bs, p.bm + b * p.b_sb + h * p.b_sh, p.b_ss, s0,
                               p.S, p.N, p.vec_b);
  ssd::load_rows<kPMax, kLDXc>(Xs, p.x + b * p.x_sb + h * p.x_sh, p.x_ss, s0,
                               p.S, p.P, p.vec_x);
  tc::cp_async_commit();
  ssd::load_dt(dts, p, b, h, s0);
  __syncthreads();
  ssd::chunk_cum(dts, p.A[h], cum);
  tc::cp_async_wait<0>();
  __syncthreads();

  const int r_lo = warp * 16 + g;  // this thread's two rows of the chunk
  const int r_hi = r_lo + 8;
  const float2* hf =
      p.hin + ((static_cast<int64_t>(b) * p.H + h) * p.nc + ci) * 32 * kFrags +
      lane;

  // one pass over n: ych = C . h_in (zero for chunk 0, as (b) writes it;
  // columns past N are zeros) and G = C . B^T for the score tiles on or
  // below the diagonal (j < 16 warp + 16)
  float ych[PT][4], gs[NT][4];
#pragma unroll
  for (int nt = 0; nt < PT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ych[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) gs[nt][e] = 0.f;
  const float* cr = Cs + r_lo * kLDNc + t;
#pragma unroll 2
  for (int kk = 0; kk < kKSteps; ++kk) {
    tf32::A a;
    a.set(cr[kk * 8], cr[kk * 8 + 8 * kLDNc], cr[kk * 8 + 4],
          cr[kk * 8 + 8 * kLDNc + 4]);
#pragma unroll
    for (int nt = 0; nt < PT; ++nt) {  // h_in's fragments straight from (b)
      const float2 f = hf[(kk * kPTiles + nt) * 32];
      tf32::mma3(ych[nt], a, f.x, f.y);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt / 2 > warp) continue;  // wholly above the diagonal
      const float* br = Bs + (nt * 8 + g) * kLDNc + kk * 8 + t;
      tf32::mma3(gs[nt], a, br[0], br[4]);
    }
  }

  // y = exp(cum_i) ych + (G * decay * dt) . x
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
  // the scores' C fragments as A (k = t <-> column 2t, k = t + 4 <->
  // column 2t + 1), x's rows in that order
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    if (kk / 2 > warp) continue;
    tf32::A a;
    a.set(gs[kk][0], gs[kk][2], gs[kk][1], gs[kk][3]);
    const float* xr = Xs + (kk * 8 + 2 * t) * kLDXc + g;
#pragma unroll
    for (int nt = 0; nt < PT; ++nt) {
      tf32::mma3(ych[nt], a, xr[nt * 8], xr[nt * 8 + kLDXc]);
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
    sizeof(float) * (L * kLDBa + L * kLDXa + 3 * L);
constexpr size_t kSmemScan =
    sizeof(float) * (2 * L * kLDNc + L * kLDXc + 2 * L);

}  // namespace

// y, h_out = ssd_scan(x, dt, A, bm, c) on `stream`, in three launches, at
// L positions a chunk.  Pointers are device pointers to float32; strides
// are in elements; y has its last dimension contiguous; h_out (B,H,N,P),
// states (B,H,nc,N,P), hin (B,H,nc,128*64, 8-byte aligned) and decay
// (B,H,nc) are contiguous float32 buffers, nc = ceil(S / L).  N <= 128;
// P <= 64.  Returns the first CUDA error, or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int ssd_scan_tc32_launch(
    const void* x, const void* dt, const void* A, const void* bm,
    const void* c, void* y, void* h_out, void* states, void* hin,
    void* decay, int64_t B, int64_t H, int64_t S, int64_t N, int64_t P,
    int64_t x_sb, int64_t x_sh, int64_t x_ss, int64_t dt_sb, int64_t dt_sh,
    int64_t dt_ss, int64_t b_sb, int64_t b_sh, int64_t b_ss, int64_t c_sb,
    int64_t c_sh, int64_t c_ss, int64_t y_sb, int64_t y_sh, int64_t y_ss,
    void* stream) {
  Params p;
  const int err = ssd::fill(p, x, dt, A, bm, c, y, h_out, states, hin,
                            decay, H, S, N, P, x_sb, x_sh, x_ss, dt_sb,
                            dt_sh, dt_ss, b_sb, b_sh, b_ss, c_sb, c_sh, c_ss,
                            y_sb, y_sh, y_ss);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p.pairs
             ? ssd::launch(ssd_chunk_state32<true>, ssd_state_pass32,
                           ssd_chunk_scan32<true>, kSmemState, kSmemScan,
                           kFrags, p, B, st)
             : ssd::launch(ssd_chunk_state32<false>, ssd_state_pass32,
                           ssd_chunk_scan32<false>, kSmemState, kSmemScan,
                           kFrags, p, B, st);
}
