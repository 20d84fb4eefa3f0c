// Flash attention forward on Hopper's tensor cores, bfloat16 (sm_90a).
//
// Replaces: flash_attention_tpu in src/repro/kernels/flash_attention.py
// for bf16 inputs (float32 inputs keep flash_attention.cu, whose float32
// products their 2e-5 limit needs).  In this package it runs the attention
// of every attention layer's bf16 prefill: internlm2-1.8b's (d 128, causal,
// 16 heads over 8 kv heads) and recurrentgemma-2b's local attention (d 256,
// 10 heads over one kv head, causal, window 2048).
//
// What it computes: q (B,H,S,d), k/v (B,K,T,d) bf16 with H = K*G; head h
// reads kv head h/G.  s = (q . k) * scale; a key is masked when k_pos >=
// t_actual, (causal) k_pos > q_pos, or (window) q_pos - k_pos >= window;
// masked scores are -1e30, never -inf; softmax in float32 by the online
// recurrence; out = acc / max(l, 1e-30), cast to bf16.  The plain version
// scales q before the product; here the float32 score is scaled after it.
// A bf16 x bf16 product is exact in float32, so the two differ by the
// rounding of the sum and of one multiply: a few float32 ulps of a score.
//
// Bound: operations.  At internlm2-1.8b's prefill (B 4, H 16, K 8, S = T =
// 2000, d 128, causal) the function is 4*B*H*d*S(S+1)/2 = 65.6 GFLOP on
// 98 MB: 0.066 ms at 989 TFLOP/s against 0.029 ms at 3.35 TB/s.  At
// recurrentgemma-2b's (B 4, H 10, K 1, d 256) 81.96 GFLOP on 90.1 MB: 0.083
// ms against 0.027 ms.  The split P.V below adds half again to the
// tensor-core work (three products where two would do).
//
// Design: FlashAttention-2's forward with mma.sync.  One CTA of 4 warps per
// (64-row q tile, head, batch); each warp owns 16 query rows, so its scores
// and output stay in registers (S: 16 x 64 f32, O: 16 x d f32).  Q, K and
// V live in shared memory as bf16 in rows padded by 16 bytes (ldmatrix
// reads a column of 8 rows without bank conflicts); K/V tiles of 64 keys
// (32 at d 256) are double-buffered with cp.async, the next tile loading
// while this one computes.  S = Q.K^T is one bf16 mma.m16n8k16 per
// 16-deep step with f32 accumulation.  The softmax runs on the S
// fragments in float32 registers
// (row max and sum over the 4 lanes of a quad by shuffles), and l sums the
// unrounded f32 P.  O += P.V splits P: P_hi = bf16(P), P_lo = bf16(P -
// P_hi), two mma against the bf16 V (exact), because one bf16 rounding of
// P moves near-zero outputs past the bf16 limit of 1e-4 absolute (about 1%
// of the elements at internlm2-1.8b's shape with q and k at std 1.5),
// while the split keeps P to 16 bits and the output within float32
// rounding of the exact result.  Key tiles wholly in the future (causal),
// wholly before the window, or at or past t_actual are never loaded, and
// the q tiles are issued from the last (the most keys) to the first, so
// the long CTAs start first.  Ragged S and T are masked here (rows past
// the end load as zeros), strides are arguments, so (B,S,H,d) tensors are
// read in place.  Any d up to 256 is zero-padded in shared memory to the
// tile's width (zero columns add nothing to q.k; padded output columns are
// never stored).  When every row comes in whole, aligned 16-byte chunks (d
// a multiple of 8, pointers and strides aligned: the models' tensors) the
// kernel is instantiated with VEC: rows load by cp.async and outputs are
// stored as bf16 pairs; otherwise (any other d, a view that starts
// mid-chunk) rows load and outputs are stored element by element.  Every
// sum has a fixed order and there are no atomics: two runs give the same
// bits.
//
// Resources (ptxas -v, sm_90a, CUDA 12.8), 128 threads a CTA; shared
// memory is (64 + 4 BK) rows of (d + 8) bf16; the VEC instantiations (the
// element-by-element ones take fewer registers: d 256 255, no spills; d
// 128 168):
//   d 256, BK 32: 255 registers, 20 bytes spilled; 101,376 B (2 CTAs/SM)
//   d 128, BK 64: 211 registers, no spills; 87,040 B (2 CTAs/SM)
//   d 64: 150 registers; 46,080 B.  d 32: 96 registers, 8 bytes spilled;
//   25,600 B.  d 16: 80 registers; 15,360 B.
// With 64-key tiles at d 256 the 128 output and 32 score registers a
// thread spilled 316 bytes and the kernel took 1.32 ms at recurrentgemma-
// 2b's prefill shape; with 32-key tiles it takes 0.68 ms (PERF.md).

#include "tc_mma.cuh"

namespace {

using tc::bf16;

constexpr int kBQ = 64;                // query rows per CTA
constexpr int kWarps = kBQ / 16;       // 16 query rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int64_t q_sb, q_sh, q_ss;  // element strides: batch, head, position
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int S, T, d, group, causal, window, t_actual;
  float scale;
};

// rows [row0, row0 + ROWS) of one (batch, head) slab into
// dst[ROWS][DMAX + 8]; rows at or past `limit` and columns at or past d
// are zeros.  By cp.async where VEC, else element by element
template <int DMAX, int ROWS, bool VEC>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t ss, int row0, int limit,
                                          int d) {
  constexpr int LD = DMAX + 8;
  if constexpr (VEC) {
    constexpr int kChunks = DMAX / 8;  // 16-byte chunks a row
    static_assert(ROWS * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
    for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 8;
      const bool ok = row0 + r < limit && c < d;
      const bf16* g =
          ok ? src + static_cast<int64_t>(row0 + r) * ss + c : src;
      tc::cp_async16(dst + r * LD + c, g, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DMAX; idx += kThreads) {
      const int r = idx / DMAX;
      const int c = idx % DMAX;
      dst[r * LD + c] = row0 + r < limit && c < d
                            ? src[static_cast<int64_t>(row0 + r) * ss + c]
                            : __float2bfloat16(0.f);
    }
  }
}

// BK keys a tile: 64, or 32 at d 256, where the scores of a 64-key tile
// beside the 128 output registers a thread would spill
template <int DMAX, int BK, bool VEC>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const Params p) {
  constexpr int LD = DMAX + 8;
  constexpr int KD = DMAX / 16;  // 16-deep steps of Q.K^T
  constexpr int ND = DMAX / 8;   // 8-wide column tiles of O
  constexpr int NK = BK / 8;     // 8-wide key tiles of S
  static_assert(ND % 2 == 0, "O tiles go in pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  bf16* Ks = Qs + kBQ * LD;                      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // last tile first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const bf16* qp = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kp = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vp = p.v + b * p.v_sb + kvh * p.v_sh;
  bf16* op = p.o + b * p.o_sb + h * p.o_sh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lm = lane >> 3;  // the ldmatrix matrix this lane addresses
  const int lr = lane & 7;   // and its row there
  const int row_lo = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_hi = row_lo + 8;

  // the keys this query tile can see
  int k_end = p.t_actual;
  if (p.causal) k_end = min(k_end, min(q0 + kBQ, p.S));
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  const int first = (k_begin / BK) * BK;

  load_tile<DMAX, kBQ, VEC>(Qs, qp, p.q_ss, q0, p.S, p.d);
  if (first < k_end) {
    load_tile<DMAX, BK, VEC>(Ks, kp, p.k_ss, first, p.T, p.d);
    load_tile<DMAX, BK, VEC>(Vs, vp, p.v_ss, first, p.T, p.d);
  }
  tc::cp_async_commit();

  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int buf = 0;
  for (int k0 = first; k0 < k_end; k0 += BK, buf ^= 1) {
    if (k0 + BK < k_end) {  // the next tile, into the other buffer
      load_tile<DMAX, BK, VEC>(Ks + (buf ^ 1) * BK * LD, kp, p.k_ss,
                               k0 + BK, p.T, p.d);
      load_tile<DMAX, BK, VEC>(Vs + (buf ^ 1) * BK * LD, vp, p.v_ss,
                               k0 + BK, p.T, p.d);
    }
    tc::cp_async_commit();  // an empty group when there is no next tile
    tc::cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();
    const bf16* Kb = Ks + buf * BK * LD;
    const bf16* Vb = Vs + buf * BK * LD;

    // S = Q . K^T for this warp's 16 rows
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      tc::ldmatrix_x4(a, Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                             (lane >> 4) * 8);
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kb[4];  // K rows are B's columns: no transpose
        tc::ldmatrix_x4(kb, Kb + (n * 8 + (lm >> 1) * 8 + lr) * LD +
                                kk * 16 + (lm & 1) * 8);
        tc::mma(s[n], a, kb[0], kb[1]);
        tc::mma(s[n + 1], a, kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax (rows row_lo: e 0-1, row_hi: e 2-3)
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = e < 2 ? row_lo : row_hi;
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        bool ok = kpos < p.t_actual;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        s[n][e] = ok ? s[n][e] * p.scale : kNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P_hi . V + P_lo . V, P's fragments straight from S's
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      tc::split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      tc::split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      tc::split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vb[4];  // V rows are B's k: transposed
        tc::ldmatrix_x4_trans(vb, Vb + (kk * 16 + (lm & 1) * 8 + lr) * LD +
                                      n * 8 + (lm >> 1) * 8);
        tc::mma(o[n], ph, vb[0], vb[1]);
        tc::mma(o[n], pl, vb[0], vb[1]);
        tc::mma(o[n + 1], ph, vb[2], vb[3]);
        tc::mma(o[n + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every read of this buffer is done before it refills
  }
  tc::cp_async_wait<0>();

  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? row_hi : row_lo;
    if (r >= p.S) continue;
    bf16* orow = op + static_cast<int64_t>(r) * p.o_ss;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * t;
      const __nv_bfloat162 pair = __floats2bfloat162_rn(
          o[n][2 * i] / den[i], o[n][2 * i + 1] / den[i]);
      if constexpr (VEC) {  // d is even: the pair is whole
        if (col < p.d) *reinterpret_cast<__nv_bfloat162*>(orow + col) = pair;
      } else {
        if (col < p.d) orow[col] = pair.x;
        if (col + 1 < p.d) orow[col + 1] = pair.y;
      }
    }
  }
}

template <int DMAX, int BK, bool VEC>
int launch_one(const Params& p, int64_t B, int64_t H, cudaStream_t stream) {
  constexpr size_t smem = sizeof(bf16) * (kBQ + 4 * BK) * (DMAX + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DMAX, BK, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_tc_kernel<DMAX, BK, VEC><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX, int BK = 64>
int launch(const Params& p, int64_t B, int64_t H, cudaStream_t stream,
           bool vec) {
  return vec ? launch_one<DMAX, BK, true>(p, B, H, stream)
             : launch_one<DMAX, BK, false>(p, B, H, stream);
}

// rows of `width` bf16 values in whole, 16-byte aligned chunks
bool vec16(const void* ptr, int64_t sb, int64_t sh, int64_t ss,
           int64_t width) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 &&
         sh % 8 == 0 && ss % 8 == 0 && width % 8 == 0;
}

}  // namespace

// out = attention(q, k, v) on `stream`, bf16 in and out.  Pointers are
// device pointers; strides are in elements (the last dimension is
// contiguous); 1 <= d <= 256; window <= 0 means none.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a d the
// kernel does not take.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t H, int64_t S, int64_t T, int64_t d, int64_t group, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int64_t causal, int64_t window, int64_t t_actual,
    float scale, void* stream) {
  if (d < 1 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.S = static_cast<int>(S);
  p.T = static_cast<int>(T);
  p.d = static_cast<int>(d);
  p.group = static_cast<int>(group);
  p.causal = causal != 0;
  p.window = static_cast<int>(window);
  p.t_actual = static_cast<int>(t_actual);
  p.scale = scale;
  const bool vec = vec16(q, q_sb, q_sh, q_ss, d) &&
                   vec16(k, k_sb, k_sh, k_ss, d) &&
                   vec16(v, v_sb, v_sh, v_ss, d) &&
                   reinterpret_cast<uintptr_t>(o) % 4 == 0 && o_sb % 2 == 0 &&
                   o_sh % 2 == 0 && o_ss % 2 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch<16>(p, B, H, st, vec);
  if (d <= 32) return launch<32>(p, B, H, st, vec);
  if (d <= 64) return launch<64>(p, B, H, st, vec);
  if (d <= 128) return launch<128>(p, B, H, st, vec);
  return launch<256, 32>(p, B, H, st, vec);
}
