// Mamba-2 SSD chunked scan for Hopper (sm_90a), float32 inputs, on the
// CUDA cores.
//
// Replaces: ssd_scan_tpu in src/repro/kernels/ssd_scan.py, the Pallas
// kernel of the Mamba-2 scan on the TPU, for float32 x, Bm and C (bf16
// inputs go to ssd_scan_tc.cu: tensor cores, chunks in parallel).  It is
// the earlier float32 design: ssd_scan_tc32.cu now runs the float32
// consistency gate's prefills with float32-accurate tensor-core products,
// and this kernel stays on no path, as the comparator that chip_smoke.py
// checks and times beside it.
//
// What it computes: x (B,H,S,P), dt (B,H,S) float32, A (H,) float32,
// Bm/C (B,H,S,N).  Per (batch, head), with the (N,P) state h carried from
// chunk to chunk (zero before the first), for each chunk of positions:
//   a = dt * A; cum = inclusive prefix sum of a; xdt = x * dt;
//   scores[i][j] = (C_i . B_j) * exp(cum_i - cum_j) for i >= j, else 0;
//   y_i = sum_j scores[i][j] xdt_j + exp(cum_i) * (C_i . h);
//   h = exp(cum_last) * h + sum_j exp(cum_last - cum_j) B_j (x) xdt_j.
// y is float32; after the last chunk the state is written out as a second
// output (B,H,N,P) float32, which the TPU kernel keeps in VMEM and drops:
// the model's prefill needs it for the decode cache.  Everything is float32
// arithmetic (as on the TPU).  The chunked identity holds at any chunk
// length, so the chunk here is this kernel's own (64), not the TPU's 256.
//
// Bound: operations.  At one mamba2-2.7b prefill layer (B 4, H 80,
// S 2000, P 64, N 128; Bm and C one group read with a head stride of 0)
// the chunked form at this kernel's chunk of 64 with only i >= j needs
// 2*B*H*(sum over chunks of l(l+1)/2 * (N+P) + 2*S*N*P) = 28.9 GFLOP,
// 0.43 ms at 67 TFLOP/s (float32 on the CUDA cores); the float32 inputs
// and outputs are 348.9 MB, 0.104 ms at 3.35 TB/s.
//
// Design: the simple, exact form first.  One CTA of 256 threads per
// (batch, head) walks its chunks in order with the state in shared memory
// (32 KB at N 128, P 64): the TPU's sequential chunk grid axis becomes this
// loop.  Each chunk's B, C and x*dt are staged in shared memory as float32
// (130 KB in all, dynamic); the three products (C.B^T, scores.xdt plus
// C.h, and the state update) are float32 FMAs on the CUDA cores with 4x4
// or 8x4 register tiles.  exp(cum_i - cum_j) is taken only for i >= j (it
// can overflow above the diagonal, where the TPU kernel multiplies first
// and discards); the C.B^T products there are computed with the rest and
// dropped.
// Ragged S is masked here: rows past S are staged as zero with dt = 0,
// exact no-ops on the state, so the caller pads nothing.  Strides are
// arguments: x is read through the model's (B,S,H,P) view, Bm and C with a
// head stride of 0 (one group for all heads), y written in x's layout.
// Every sum has a fixed order and there are no atomics: two runs give the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;          // positions per chunk
constexpr int kThreads = 256;   // 16 x 16: ty owns rows, tx owns columns
constexpr int kNMax = 128;      // largest state size N
constexpr int kPMax = 64;       // largest head dimension P
constexpr int kLDN = kNMax + 1; // padded rows of B and C: column walks
constexpr int kLDS = kL + 1;    // padded rows of the scores
static_assert(kL == 64 && kPMax == 64 && kNMax == 128,
              "the 16 x 16 thread tiles below assume these sizes");

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* bm;
  const float* c;
  float* y;
  float* h_out;  // (B, H, N, P), contiguous
  int64_t x_sb, x_sh, x_ss;  // element strides: batch, head, position
  int64_t dt_sb, dt_sh, dt_ss;
  int64_t b_sb, b_sh, b_ss;
  int64_t c_sb, c_sh, c_ss;
  int64_t y_sb, y_sh, y_ss;
  int H, S, N, P;
};

constexpr size_t smem_floats() {
  return 2 * kL * kLDN      // Bs, Cs
         + kL * kPMax       // Xs (x * dt)
         + kL * kLDS        // Ss (scores)
         + kNMax * kPMax    // Hs (state)
         + 3 * kL;          // cum, w, dts
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Params p) {
  extern __shared__ float smem[];
  float* Bs = smem;                 // [kL][kLDN]
  float* Cs = Bs + kL * kLDN;       // [kL][kLDN]
  float* Xs = Cs + kL * kLDN;       // [kL][kPMax]
  float* Ss = Xs + kL * kPMax;      // [kL][kLDS]
  float* Hs = Ss + kL * kLDS;       // [kNMax][kPMax]
  float* cum = Hs + kNMax * kPMax;  // [kL]
  float* w = cum + kL;              // [kL]
  float* dts = w + kL;              // [kL]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float* xp = p.x + b * p.x_sb + h * p.x_sh;
  const float* dtp = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float* bp = p.bm + b * p.b_sb + h * p.b_sh;
  const float* cp = p.c + b * p.c_sb + h * p.c_sh;
  float* yp = p.y + b * p.y_sb + h * p.y_sh;
  const float A = p.A[h];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int i = tid; i < kNMax * kPMax; i += kThreads) Hs[i] = 0.f;

  for (int s0 = 0; s0 < p.S; s0 += kL) {
    __syncthreads();  // the last chunk's reads are done; Hs is visible

    // stage the chunk; rows past S and columns past N or P are zero
    for (int idx = tid; idx < kL * kNMax; idx += kThreads) {
      const int r = idx / kNMax;
      const int n = idx % kNMax;
      float bv = 0.f, cv = 0.f;
      if (s0 + r < p.S && n < p.N) {
        bv = bp[static_cast<int64_t>(s0 + r) * p.b_ss + n];
        cv = cp[static_cast<int64_t>(s0 + r) * p.c_ss + n];
      }
      Bs[r * kLDN + n] = bv;
      Cs[r * kLDN + n] = cv;
    }
    for (int idx = tid; idx < kL * kPMax; idx += kThreads) {
      const int r = idx / kPMax;
      const int c = idx % kPMax;
      float xv = 0.f;
      if (s0 + r < p.S && c < p.P) {
        xv = xp[static_cast<int64_t>(s0 + r) * p.x_ss + c];
      }
      Xs[idx] = xv;
    }
    if (tid < kL) {
      dts[tid] = s0 + tid < p.S ? dtp[static_cast<int64_t>(s0 + tid) * p.dt_ss]
                                : 0.f;  // dt = 0: an exact no-op step
    }
    __syncthreads();

    // log-decay prefix sums (one thread, in order) and xdt = x * dt
    if (tid == 0) {
      float run = 0.f;
      for (int r = 0; r < kL; ++r) {
        run += dts[r] * A;
        cum[r] = run;
      }
    }
    for (int idx = tid; idx < kL * kPMax; idx += kThreads) {
      Xs[idx] *= dts[idx / kPMax];
    }
    __syncthreads();

    // w_j = exp(cum_last - cum_j), the weight of position j in the update;
    // scores[i][j] = (C_i . B_j) * exp(cum_i - cum_j) for i >= j
    if (tid < kL) w[tid] = expf(cum[kL - 1] - cum[tid]);
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
      for (int n = 0; n < kNMax; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * kLDN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * kLDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          Ss[r * kLDS + c] = c <= r ? acc[i][j] * expf(cum[r] - cum[c]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y_r = sum_j scores[r][j] xdt_j + exp(cum_r) * (C_r . h)
    {
      float acc[4][4], hacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][q] = 0.f;
          hacc[i][q] = 0.f;
        }
#pragma unroll 8
      for (int j = 0; j < kL; ++j) {
        float sv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * kLDS + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = Xs[j * kPMax + tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(sv[i], xv[q], acc[i][q]);
      }
#pragma unroll 8
      for (int n = 0; n < kNMax; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * kLDN + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[q] = Hs[n * kPMax + tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            hacc[i][q] = fmaf(cv[i], hv[q], hacc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (s0 + r >= p.S) continue;
        const float e = expf(cum[r]);
        float* yrow = yp + static_cast<int64_t>(s0 + r) * p.y_ss;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = tx + 16 * q;
          if (c < p.P) yrow[c] = acc[i][q] + e * hacc[i][q];
        }
      }
    }
    __syncthreads();  // every read of the incoming state is done

    // h = exp(cum_last) * h + sum_j (w_j B_j) (x) xdt_j; each thread owns
    // 8 x 4 entries of h and updates them in place
    {
      const float decay = expf(cum[kL - 1]);
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kL; ++j) {
        const float wj = w[j];
        float bv[8], xv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) bv[i] = Bs[j * kLDN + ty + 16 * i] * wj;
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = Xs[j * kPMax + tx + 16 * q];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(bv[i], xv[q], acc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float* hv = Hs + (ty + 16 * i) * kPMax + tx + 16 * q;
          *hv = decay * *hv + acc[i][q];
        }
    }
  }
  __syncthreads();

  float* hp = p.h_out + (static_cast<int64_t>(b) * p.H + h) * p.N * p.P;
  for (int idx = tid; idx < p.N * p.P; idx += kThreads) {
    hp[idx] = Hs[(idx / p.P) * kPMax + idx % p.P];
  }
}

int launch(const Params& p, int64_t B, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(p.H), static_cast<unsigned>(B));
  ssd_scan_kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y, h_out = ssd_scan(x, dt, A, bm, c) on `stream`.  Pointers are device
// pointers, strides are in elements (the last dimension of x, bm, c and y
// is contiguous; h_out is a contiguous (B,H,N,P) buffer); x, bm, c, dt and
// A are float32 (bf16 inputs go to ssd_scan_tc.cu).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for N or P beyond the kernel's tiles.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* bm,
    const void* c, void* y, void* h_out, int64_t B, int64_t H, int64_t S,
    int64_t N, int64_t P, int64_t x_sb, int64_t x_sh, int64_t x_ss,
    int64_t dt_sb, int64_t dt_sh, int64_t dt_ss, int64_t b_sb, int64_t b_sh,
    int64_t b_ss, int64_t c_sb, int64_t c_sh, int64_t c_ss, int64_t y_sb,
    int64_t y_sh, int64_t y_ss, void* stream) {
  if (N < 1 || N > kNMax || P < 1 || P > kPMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const float*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.bm = static_cast<const float*>(bm);
  p.c = static_cast<const float*>(c);
  p.y = static_cast<float*>(y);
  p.h_out = static_cast<float*>(h_out);
  p.x_sb = x_sb; p.x_sh = x_sh; p.x_ss = x_ss;
  p.dt_sb = dt_sb; p.dt_sh = dt_sh; p.dt_ss = dt_ss;
  p.b_sb = b_sb; p.b_sh = b_sh; p.b_ss = b_ss;
  p.c_sb = c_sb; p.c_sh = c_sh; p.c_ss = c_ss;
  p.y_sb = y_sb; p.y_sh = y_sh; p.y_ss = y_ss;
  p.H = static_cast<int>(H);
  p.S = static_cast<int>(S);
  p.N = static_cast<int>(N);
  p.P = static_cast<int>(P);
  return launch(p, B, static_cast<cudaStream_t>(stream));
}
