// Flash attention forward on Hopper's tensor cores, float32 (sm_90a).
//
// Replaces: flash_attention_tpu in src/repro/kernels/flash_attention.py
// for float32 inputs (bf16 inputs go to flash_attention_tc.cu).  In this
// package it runs the attention of the float32 consistency gates'
// prefills: internlm2-1.8b's (d 128, causal, 16 heads over 8 kv heads) and
// recurrentgemma-2b's local attention (d 256, 10 heads over one kv head,
// causal, window 2048), and of any model served with dtype float32.
//
// What it computes: q (B,H,S,d), k/v (B,K,T,d) float32 with H = K*G; head
// h reads kv head h/G.  s = (q . k) * scale; a key is masked when k_pos >=
// t_actual, (causal) k_pos > q_pos, or (window) q_pos - k_pos >= window;
// masked scores are -1e30, never -inf; softmax in float32 by the online
// recurrence; out = acc / max(l, 1e-30), float32.  The plain version
// scales q before the product; here the float32 score is scaled after it.
//
// Arithmetic: both products on the tensor cores as float32-accurate
// products, three TF32 mma.sync.m16n8k8 each (tf32_mma.cuh: x = hi + lo,
// hi.hi + hi.lo + lo.hi, the large term and the two small ones in two
// accumulator chains).  A product rounded once to TF32 moves outputs at q,
// k std 1.5 and d 128 far past the float32 limit of 2e-5, and two bf16
// parts an operand spend more than half of it, where this split spends
// under a quarter (tests/test_torch_tc32_rounding.py emulates each).  The
// tensor cores round each accumulation toward zero, so the products are
// summed in short chains and added to S and O on the CUDA cores (kKG).
//
// Bound: operations.  At internlm2-1.8b's prefill (B 4, H 16, K 8, S = T
// = 2000, d 128, causal) the function is 4*B*H*d*S(S+1)/2 = 65.6 GFLOP on
// 196 MB: 0.397 ms at 165 TFLOP/s (float32-accurate tensor-core products,
// a third of the 495 TF32 rate) against 0.059 ms at 3.35 TB/s.  At
// recurrentgemma-2b's (B 4, H 10, K 1, d 256) 81.96 GFLOP: 0.497 ms.
//
// Design: FlashAttention-2's forward with mma.sync, as flash_attention_tc.cu,
// with float32 tiles.  One CTA per (64-row q tile, head, batch); Q, K and V
// live in shared memory as float32, rows padded by 4 floats (a row pitch
// of 4 mod 32 words: the scalar fragment loads of a warp hit 32 banks),
// K/V tiles of 32 keys double-buffered with cp.async; the split into TF32
// hi and lo happens as a fragment is loaded, so shared memory holds each
// value once.  S's C fragments are P.V's A fragment in registers, with P.V
// contracting over the keys in the order of tf32_mma.cuh (V's rows 2t and
// 2t+1 as b0 and b1).  The softmax runs on the fragments in float32, l sums
// the unrounded P.  Up to d 128 a warp owns 16 query rows and all of d (4
// warps, 101,376 B of shared memory, two CTAs an SM).  At d 256 the 16 x
// 256 output would take 128 registers a thread beside the scores, so two
// warps share 16 rows: each forms the partial scores over its half of d,
// they add the two halves through shared memory (a + b on both sides: the
// same bits), and each keeps its half of O (8 warps, 216,064 B).  Key
// tiles wholly in the future (causal), wholly before the window, or at or
// past t_actual are never loaded; q tiles are issued from the last (the
// most keys) to the first.  Ragged S and T are masked here; strides are
// arguments, so (B,S,H,d) tensors are read in place; rows whole in aligned
// 16-byte chunks load by cp.async, others (d not a multiple of 4, an
// unaligned view) element by element; columns past d are zeros in shared
// memory (no branch in the product loops: they add nothing, and their
// outputs are not stored).  Every sum has a fixed order and there are no
// atomics: two runs give the same bits.
//
// Resources (ptxas -v, sm_90a, CUDA 12.8), no spills: d 256 (8 warps)
// 255 registers, 216,064 B of shared memory, one CTA an SM; d 128 (4
// warps) 173 registers, 101,376 B, two CTAs an SM; d 64 167; d 32 80.

#include "tf32_mma.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 32;  // keys per K/V tile
// 8-deep steps of Q.K^T summed on the tensor cores before a float32 add.
// The tensor cores add each product to their accumulator with a rounding
// toward zero, so a long chain of mma into one accumulator drifts (all
// roundings have one sign); short chains started from zero, each added to
// the running sum on the CUDA cores (round to nearest), keep the drift to
// a few such roundings of a short partial sum.  P.V likewise: each K/V
// tile's product starts from zero and is added to O in float32
constexpr int kKG = 4;
constexpr float kNeg = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t q_sb, q_sh, q_ss;  // element strides: batch, head, position
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int S, T, d, group, causal, window, t_actual;
  float scale;
  bool vec_q, vec_k, vec_v;  // rows in whole, aligned 16-byte chunks
  bool vec_o;                // float2 stores
};

// rows [row0, row0 + ROWS) of one (batch, head) slab into
// dst[ROWS][DMAX + 4]; rows at or past `limit` and columns at or past d
// are zeros.  By cp.async where `vec`, else element by element
template <int DMAX, int ROWS, int NT>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ss, int row0, int limit,
                                          int d, bool vec) {
  constexpr int LD = DMAX + 4;
  if (vec) {
    constexpr int kChunks = DMAX / 4;  // 16-byte chunks a row
    static_assert(ROWS * kChunks % NT == 0, "whole chunks per thread");
#pragma unroll
    for (int it = 0; it < ROWS * kChunks / NT; ++it) {
      const int idx = it * NT + threadIdx.x;
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * 4;
      const bool ok = row0 + r < limit && c < d;
      const float* g =
          ok ? src + static_cast<int64_t>(row0 + r) * ss + c : src;
      tc::cp_async16(dst + r * LD + c, g, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * DMAX; idx += NT) {
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    dst[r * LD + c] = row0 + r < limit && c < d
                          ? src[static_cast<int64_t>(row0 + r) * ss + c]
                          : 0.f;
  }
}

// WN warps share 16 query rows, each owning DMAX / WN columns of d
template <int DMAX, int WN>
__global__ void __launch_bounds__(128 * WN)
flash_tc32_kernel(const Params p) {
  constexpr int NT = 128 * WN;  // threads
  constexpr int LD = DMAX + 4;
  constexpr int DW = DMAX / WN;  // a warp's columns of d
  constexpr int KD = DW / 8;     // its 8-deep steps of Q.K^T
  constexpr int ND = DW / 8;     // its 8-wide column tiles of O
  constexpr int NK = kBK / 8;    // 8-wide key tiles of S
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;      // [2][kBK][LD]
  float* Vs = Ks + 2 * kBK * LD;  // [2][kBK][LD]
  float* Xs = Vs + 2 * kBK * LD;  // WN 2: [8 warps][NK][4][32] half scores

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // last tile first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const float* qp = p.q + b * p.q_sb + h * p.q_sh;
  const float* kp = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vp = p.v + b * p.v_sb + kvh * p.v_sh;
  float* op = p.o + b * p.o_sb + h * p.o_sh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rw = warp & 3;        // the warp's 16 rows
  const int c0 = (warp >> 2) * DW;  // and its first column of d
  const int row_lo = q0 + rw * 16 + g;  // this thread's two query rows
  const int row_hi = row_lo + 8;
  const float* qa = Qs + (rw * 16 + g) * LD + c0 + t;  // its A elements

  // the keys this query tile can see
  int k_end = p.t_actual;
  if (p.causal) k_end = min(k_end, min(q0 + kBQ, p.S));
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  const int first = (k_begin / kBK) * kBK;

  load_tile<DMAX, kBQ, NT>(Qs, qp, p.q_ss, q0, p.S, p.d, p.vec_q);
  if (first < k_end) {
    load_tile<DMAX, kBK, NT>(Ks, kp, p.k_ss, first, p.T, p.d, p.vec_k);
    load_tile<DMAX, kBK, NT>(Vs, vp, p.v_ss, first, p.T, p.d, p.vec_v);
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
  for (int k0 = first; k0 < k_end; k0 += kBK, buf ^= 1) {
    if (k0 + kBK < k_end) {  // the next tile, into the other buffer
      load_tile<DMAX, kBK, NT>(Ks + (buf ^ 1) * kBK * LD, kp, p.k_ss,
                               k0 + kBK, p.T, p.d, p.vec_k);
      load_tile<DMAX, kBK, NT>(Vs + (buf ^ 1) * kBK * LD, vp, p.v_ss,
                               k0 + kBK, p.T, p.d, p.vec_v);
    }
    tc::cp_async_commit();  // an empty group when there is no next tile
    tc::cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();
    const float* Kb = Ks + buf * kBK * LD;
    const float* Vb = Vs + buf * kBK * LD;

    // S = Q . K^T for this warp's 16 rows, over its columns of d, in
    // groups of kKG 8-deep steps summed on the tensor cores and added in
    // float32 (see kKG)
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int k0g = 0; k0g < KD; k0g += kKG) {
      float big[NK][4] = {}, small[NK][4] = {};
#pragma unroll
      for (int kk = k0g; kk < k0g + kKG; ++kk) {
        tf32::A a;
        a.set(qa[kk * 8], qa[kk * 8 + 8 * LD], qa[kk * 8 + 4],
              qa[kk * 8 + 8 * LD + 4]);
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float* kr = Kb + (n * 8 + g) * LD + c0 + kk * 8 + t;
          tf32::mma3(big[n], small[n], a, kr[0], kr[4]);
        }
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += big[n][e] + small[n][e];
    }
    if constexpr (WN > 1) {  // add the other half of d's partial scores
      static_assert(WN == 2, "two warps share a row tile");
      float* mine = Xs + warp * (NK * 4 * 32) + lane;
      const float* theirs = Xs + (warp ^ 4) * (NK * 4 * 32) + lane;
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = s[n][e];
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + rw) : "memory");
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += theirs[(n * 4 + e) * 32];
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

    // O += P . V: P's A fragment from S's C fragments (k = t <-> key 2t,
    // k = t + 4 <-> key 2t + 1), V's rows 2t and 2t + 1 in that order; this
    // tile's product summed on the tensor cores, then added in float32
    tf32::A pa[NK];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      pa[kk].set(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      float big[4] = {}, small[4] = {};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const float* vr = Vb + (kk * 8 + 2 * t) * LD + c0 + n * 8 + g;
        tf32::mma3(big, small, pa[kk], vr[0], vr[LD]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] += big[e] + small[e];
    }
    __syncthreads();  // every read of this buffer is done before it refills
  }
  tc::cp_async_wait<0>();

  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? row_hi : row_lo;
    if (r >= p.S) continue;
    float* orow = op + static_cast<int64_t>(r) * p.o_ss;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = c0 + n * 8 + 2 * t;
      const float v0 = o[n][2 * i] / den[i];
      const float v1 = o[n][2 * i + 1] / den[i];
      if (p.vec_o && col + 1 < p.d) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
      } else {
        if (col < p.d) orow[col] = v0;
        if (col + 1 < p.d) orow[col + 1] = v1;
      }
    }
  }
}

template <int DMAX, int WN = 1>
int launch(const Params& p, int64_t B, int64_t H, cudaStream_t stream) {
  constexpr int NT = 128 * WN;
  constexpr size_t smem =
      sizeof(float) * ((kBQ + 4 * kBK) * (DMAX + 4) +
                       (WN > 1 ? 8 * kBK * 4 * 4 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc32_kernel<DMAX, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_tc32_kernel<DMAX, WN><<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// rows of `width` floats in whole, 16-byte aligned chunks
bool vec16(const void* ptr, int64_t sb, int64_t sh, int64_t ss,
           int64_t width) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 &&
         sh % 4 == 0 && ss % 4 == 0 && width % 4 == 0;
}

}  // namespace

// out = attention(q, k, v) on `stream`, float32 in and out.  Pointers are
// device pointers; strides are in elements (the last dimension is
// contiguous); 1 <= d <= 256; window <= 0 means none.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a d the
// kernel does not take.
extern "C" int flash_attention_tc32_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t H, int64_t S, int64_t T, int64_t d, int64_t group, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int64_t causal, int64_t window, int64_t t_actual,
    float scale, void* stream) {
  if (d < 1 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
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
  p.vec_q = vec16(q, q_sb, q_sh, q_ss, d);
  p.vec_k = vec16(k, k_sb, k_sh, k_ss, d);
  p.vec_v = vec16(v, v_sb, v_sh, v_ss, d);
  p.vec_o = reinterpret_cast<uintptr_t>(o) % 8 == 0 && o_sb % 2 == 0 &&
            o_sh % 2 == 0 && o_ss % 2 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32) return launch<32>(p, B, H, st);
  if (d <= 64) return launch<64>(p, B, H, st);
  if (d <= 128) return launch<128>(p, B, H, st);
  return launch<256, 2>(p, B, H, st);
}
