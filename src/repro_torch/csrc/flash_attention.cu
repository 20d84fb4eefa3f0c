// Flash attention forward (GQA; causal, sliding window or full) for Hopper
// (sm_90a), float32 inputs, on the CUDA cores.
//
// Replaces: flash_attention_tpu in src/repro/kernels/flash_attention.py,
// the Pallas kernel that serves attention on the TPU, for float32 inputs
// (bf16 inputs go to flash_attention_tc.cu, on the tensor cores).  It is
// the earlier float32 design: flash_attention_tc32.cu now runs the float32
// consistency gates' prefills (internlm2-1.8b's d 128, recurrentgemma-2b's
// d 256 with MQA and a window) with float32-accurate tensor-core products,
// and this kernel stays on no path, as the comparator that chip_smoke.py
// checks and times beside it.
//
// What it computes: q (B,H,S,d), k/v (B,K,T,d) with H = K*G; head h reads
// kv head h/G.  s = (float(q) * scale) . float(k); a key is masked when
// k_pos >= t_actual, (causal) k_pos > q_pos, or (window) q_pos - k_pos >=
// window; masked scores are -1e30, never -inf; softmax in float32 by the
// online recurrence (running max m, denominator l, accumulator acc per query
// row); out = acc / max(l, 1e-30), float32.
//
// Bound: operations.  At the prefill shape of internlm2-1.8b (B 4, H 16,
// K 8, S = T = 2000, d 128, causal) the kernel does 4*B*H*d*S(S+1)/2 =
// 65.6 GFLOP on 196 MB of float32 q, k, v and out: 0.98 ms at 67 TFLOP/s
// (float32 on the CUDA cores) against 0.059 ms at 3.35 TB/s.  At
// recurrentgemma-2b's (B 4, H 10, K 1, S = T = 2000, d 256, causal; the
// window of 2048 does not bind) 81.96 GFLOP: 1.22 ms.
//
// Design: the simple, exact form first.  The TPU walks a sequential kv grid
// axis with the accumulators in VMEM scratch; here one CTA of 256 threads
// owns a 64-row query tile of one (batch, head) and loops over 64-key tiles
// itself, so m, l and acc stay in registers (4 rows x D/16 columns a
// thread).  Q (scaled), K and V tiles are staged in shared memory as float32
// (115 KB at d = 128 and 213,760 B of the 232,448 a block may take at
// d = 256, so one CTA per SM there: dynamic shared memory, raised with
// cudaFuncSetAttribute).  Scores and P.V are float32 FMAs on the CUDA cores,
// the TPU kernel's float32 arithmetic.  Key tiles wholly in the future
// (causal), wholly before the window, or wholly at or past t_actual are
// never loaded.  Ragged S and T are masked here, so the caller pads
// nothing; strides are arguments, so (B,S,H,d) tensors are read in place.
// Row sums are butterfly shuffles and every sum has a fixed order, with no
// atomics: two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 x 16: ty owns rows, tx owns columns
constexpr float kNeg = -1e30f;
static_assert(kBQ == kBK, "stage() moves kBK rows for Q as for K and V");

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
};


// Rows [row0, row0 + 64) of one (batch, head) slab into dst[64][ld] as
// float32 times `mul`; rows at or past `limit` and columns at or past d are
// zero, so they add nothing to a dot product and stay finite.
template <int DMAX>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int64_t ss, int row0, int limit, int d,
                                      float mul) {
#pragma unroll 4
  for (int it = 0; it < kBK * DMAX / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / DMAX;
    const int c = idx % DMAX;
    float x = 0.f;
    if (row0 + r < limit && c < d) {
      x = src[static_cast<int64_t>(row0 + r) * ss + c] * mul;
    }
    dst[r * ld + c] = x;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int LDQ = DMAX + 1;  // padded: a column walk hits 16 banks
  constexpr int LDV = DMAX;
  constexpr int LDP = kBK + 1;
  constexpr int NC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [kBQ][LDQ]
  float* Ks = Qs + kBQ * LDQ;     // [kBK][LDQ]
  float* Vs = Ks + kBK * LDQ;     // [kBK][LDV]
  float* Ps = Vs + kBK * LDV;     // [kBQ][LDP]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const float* qp = p.q + b * p.q_sb + h * p.q_sh;
  const float* kp = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vp = p.v + b * p.v_sb + kvh * p.v_sh;
  float* op = p.o + b * p.o_sb + h * p.o_sh;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  stage<DMAX>(Qs, LDQ, qp, p.q_ss, q0, p.S, p.d, p.scale);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the keys this query tile can see
  int k_end = p.t_actual;
  if (p.causal) k_end = min(k_end, min(q0 + kBQ, p.S));
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's reads are done; Qs is visible
    stage<DMAX>(Ks, LDQ, kp, p.k_ss, k0, p.T, p.d, 1.f);
    stage<DMAX>(Vs, LDV, vp, p.v_ss, k0, p.T, p.d, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DMAX; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LDQ + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LDQ + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < p.t_actual;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        if (!ok) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 lanes of a row are one half-warp: xor 8..1 stays inside it
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * LDV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = op + r * p.o_ss;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < p.d) orow[col] = acc[i][c] / den;
    }
  }
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (DMAX + 1) + kBK * (DMAX + 1) + kBK * DMAX +
                          kBQ * (kBK + 1));
}

template <int DMAX>
int launch(const Params& p, int64_t B, int64_t H, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  flash_fwd_kernel<DMAX><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int64_t B, int64_t H, cudaStream_t stream) {
  if (p.d <= 16) return launch<16>(p, B, H, stream);
  if (p.d <= 32) return launch<32>(p, B, H, stream);
  if (p.d <= 64) return launch<64>(p, B, H, stream);
  if (p.d <= 128) return launch<128>(p, B, H, stream);
  if (p.d <= 256) return launch<256>(p, B, H, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// out = attention(q, k, v) on `stream`.  Pointers are device pointers,
// strides are in elements (the last dimension is contiguous); window <= 0
// means none; q, k, v and out are float (bf16 inputs go to
// flash_attention_tc.cu).  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t H, int64_t S, int64_t T, int64_t d, int64_t group, int64_t q_sb,
    int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
    int64_t o_ss, int64_t causal, int64_t window, int64_t t_actual,
    float scale, void* stream) {
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
  return dispatch(p, B, H, static_cast<cudaStream_t>(stream));
}
