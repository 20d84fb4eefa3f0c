"""The arithmetic of the two tensor-core kernels, emulated on the CPU.

``csrc/flash_attention_tc.cu`` and ``csrc/ssd_scan_tc.cu`` run only on the
card.  Their rounding does not: the emulations here repeat it in PyTorch on
float32 CPU tensors (a product of two bf16 values is exact in float32, as
in ``mma.sync`` with float32 accumulation), so that the design is held to
the limits the card's checks use (``chip_smoke.py`` phases 1b and 1c)
before it reaches the card, and each check is shown to fail for the design
it rules out.

* attention: key tiles of 64 with the online softmax, the score scaled after
  Q.K^T, and P split into bf16 hi + lo for P.V; held at phase 1b's bf16
  limits (rtol 1e-2, atol 1e-4, q and k drawn at std 1.5) to the port's
  plain version and the JAX package's reference and Pallas kernel (in
  interpret mode).  One bf16 rounding of P fails those limits.
* SSD scan: chunk-local states, the sequential pass over chunks and each
  chunk's output, at the kernel's chunk of 64, with each float32 operand
  split into bf16 hi + lo against a bf16 one; held at 1e-4 per
  256-position chunk (and for the final state) to the plain version and
  the JAX package's oracle and Pallas kernel, with dt and A in Mamba-2's
  published ranges.  One bf16 rounding of the float32 operands fails 1e-4.

Also: the wrappers' dtype dispatch names the kernel and its launch counter
for each dtype, without launching anything.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import tree_from_numpy
from repro_torch.kernels import (flash_attention_tc, flash_attention_tc32,
                                 ops, ref, ssd_scan_tc, ssd_scan_tc32)

NEG = -1e30
# phase 1b's bf16 limits at the main shapes and the distribution of q and k
ATTN_RTOL, ATTN_ATOL, QK_STD = 1e-2, 1e-4, 1.5
# phase 1c's limit per SSD_CHECK_CHUNK positions and for the state
SSD_TOL, SSD_CHECK_CHUNK = 1e-4, 256
KEY_TILE = 64            # kBK of flash_attention_tc.cu
SSD_CHUNK = ssd_scan_tc.CHUNK


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to float32."""
    return x.to(torch.bfloat16).float()


def _split(x: torch.Tensor):
    """The kernels' split rule: hi = bf16(x), lo = bf16(x - hi)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _t(a: np.ndarray) -> torch.Tensor:
    return tree_from_numpy({"a": a}, device="cpu")["a"]


# -- attention ---------------------------------------------------------------

def flash_tc_emulation(q, k, v, *, causal=True, window=None, scale=None,
                       split_p=True):
    """flash_attention_tc.cu's arithmetic: q (B,H,S,d), k/v (B,K,T,d) bf16
    -> (B,H,S,d) bf16.  ``split_p=False`` rounds P once to bf16 instead."""
    B, H, S, d = q.shape
    K, T = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    qf = q.float()
    kf = k.float().repeat_interleave(H // K, dim=1)
    vf = v.float().repeat_interleave(H // K, dim=1)
    q_pos = torch.arange(S)[:, None]
    m = torch.full((B, H, S), NEG)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, d))
    for k0 in range(0, T, KEY_TILE):
        kt, vt = kf[:, :, k0:k0 + KEY_TILE], vf[:, :, k0:k0 + KEY_TILE]
        s = (qf @ kt.transpose(-1, -2)) * scale  # scaled after the product
        k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = torch.ones((S, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok = ok & (k_pos <= q_pos)
        if window is not None:
            ok = ok & (q_pos - k_pos < window)
        s = torch.where(ok, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)  # the unrounded P
        if split_p:
            p_hi, p_lo = _split(p)
            pv = p_hi @ vt + p_lo @ vt
        else:
            pv = _bf16(p) @ vt
        acc = acc * alpha[..., None] + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


def attention_case(B, H, K, S, d, seed):
    """q, k at std QK_STD and v at std 0.4, bf16 numpy arrays."""
    rng = np.random.default_rng(seed)

    def mk(heads, std):
        a = rng.standard_normal((B, heads, S, d)) * std
        return a.astype(np.float32).astype(ml_dtypes.bfloat16)
    return mk(H, QK_STD), mk(K, QK_STD), mk(K, 0.4)


def _outside(got, want) -> int:
    """Elements outside rtol ATTN_RTOL, atol ATTN_ATOL (torch.allclose)."""
    g, w = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    return int((~torch.isclose(g, w, rtol=ATTN_RTOL, atol=ATTN_ATOL)).sum())


@pytest.mark.parametrize("B,H,K,S,d,window", [
    (1, 4, 2, 2000, 128, None),   # internlm2-1.8b's prefill, 4 heads
    (1, 2, 1, 1024, 256, 2048),   # recurrentgemma-2b's local attention
    (1, 2, 1, 600, 256, 256),     # a window that binds
])
def test_flash_tc_arithmetic_within_phase_1b_limits(B, H, K, S, d, window):
    q, k, v = attention_case(B, H, K, S, d, seed=S + d)
    tq, tk, tv = _t(q), _t(k), _t(v)
    got = flash_tc_emulation(tq, tk, tv, window=window)
    plain = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    assert got.dtype == torch.bfloat16 and bool(got.float().isfinite().all())
    assert _outside(got, plain.float().numpy()) == 0
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True,
                                      window=window)
    assert _outside(got, oracle) == 0


def test_flash_tc_arithmetic_matches_pallas_interpret():
    """Against the TPU kernel itself, interpreted on the CPU, at S 512."""
    q, k, v = attention_case(1, 2, 1, 512, 128, seed=5)
    got = flash_tc_emulation(_t(q), _t(k), _t(v))
    kern = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, q_block=256,
                                kv_block=256, impl="interpret")
    assert _outside(got, kern) == 0


def test_single_bf16_p_fails_phase_1b_limits():
    """The check can fail: with P rounded once to bf16 (FlashAttention-2's
    usual P.V) near-zero outputs leave the 1e-4 absolute limit."""
    q, k, v = attention_case(1, 4, 2, 2000, 128, seed=2128)
    tq, tk, tv = _t(q), _t(k), _t(v)
    plain = ref.flash_attention_ref(tq, tk, tv, causal=True).float().numpy()
    once = flash_tc_emulation(tq, tk, tv, split_p=False)
    assert _outside(once, plain) > 100
    assert _outside(flash_tc_emulation(tq, tk, tv), plain) == 0


# -- SSD scan ----------------------------------------------------------------

def ssd_tc_emulation(x, dt, A, Bm, C, *, chunk=SSD_CHUNK, split=True):
    """ssd_scan_tc.cu's three passes: x (B,H,S,P), Bm/C (B,H,S,N) bf16, dt
    (B,H,S) and A (H,) float32 -> y (B,H,S,P), h (B,H,N,P) float32.
    ``split=False`` rounds each float32 operand once to bf16 instead."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(t):  # (B,H,S,...) -> (B,H,nc,chunk,...), zeros past S
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((B, H, pad) + t.shape[3:])], dim=2)
        return t.reshape((B, H, nc, chunk) + t.shape[3:])

    def prod(a, b):  # a float32 operand against an exact bf16 one
        if split:
            hi, lo = _split(a)
            return hi @ b + lo @ b
        return _bf16(a) @ b

    xc, bc, cc, dtc = chunks(x), chunks(Bm), chunks(C), chunks(dt)
    cum = torch.cumsum(dtc * A[None, :, None, None], dim=-1)
    last = cum[..., -1:]
    # (a) chunk-local states and decays
    w = torch.exp(last - cum) * dtc
    states = prod((bc * w[..., None]).transpose(-1, -2), xc)  # (..., N, P)
    decay = torch.exp(last[..., 0])
    # (b) the state entering each chunk
    h = torch.zeros((B, H, N, P))
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, :, c, None, None] * h + states[:, :, c]
    h_in = torch.stack(h_in, dim=2)
    # (c) each chunk's output
    i = torch.arange(chunk)[:, None]
    j = torch.arange(chunk)[None, :]
    below = j <= i
    diff = torch.where(below, cum[..., :, None] - cum[..., None, :], 0.0)
    gram = cc @ bc.transpose(-1, -2)  # bf16 x bf16: exact products
    scores = torch.where(below, gram * torch.exp(diff) * dtc[..., None, :],
                         0.0)
    if split:
        hi, lo = _split(h_in)
        ch = cc @ hi + cc @ lo
    else:
        ch = cc @ _bf16(h_in)
    y = prod(scores, xc) + torch.exp(cum)[..., None] * ch
    return y.reshape(B, H, nc * chunk, P)[:, :, :S], h


def ssd_case(B, H, S, P, N, seed):
    """x, Bm, C bf16 (Bm and C one group over the heads, std 1 as in
    chip_smoke's prefill inputs); dt log-uniform in [1e-3, 1e-1] and
    A = -U[1, 16], Mamba-2's published ranges, as numpy arrays."""
    rng = np.random.default_rng(seed)
    bf = ml_dtypes.bfloat16
    x = rng.standard_normal((B, H, S, P)).astype(np.float32).astype(bf)
    bm = np.broadcast_to(rng.standard_normal((B, 1, S, N)).astype(
        np.float32).astype(bf), (B, H, S, N)).copy()
    c = np.broadcast_to(rng.standard_normal((B, 1, S, N)).astype(
        np.float32).astype(bf), (B, H, S, N)).copy()
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, H, S))).astype(
        np.float32)
    A = -rng.uniform(1, 16, H).astype(np.float32)
    return x, dt, A, bm, c


def chunk_errors(y, want, chunk=SSD_CHECK_CHUNK):
    """Per ``chunk`` positions of S: max |y - want| over max |want|."""
    y, want = (np.asarray(a, np.float32) for a in (y, want))
    return [float(np.abs(y[:, :, s:s + chunk] - want[:, :, s:s + chunk]).max()
                  / max(1e-30, np.abs(want[:, :, s:s + chunk]).max()))
            for s in range(0, want.shape[2], chunk)]


def _state_err(h, want):
    h, want = np.asarray(h, np.float32), np.asarray(want, np.float32)
    return float(np.abs(h - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def ssd_main():
    """4 heads of a mamba2-2.7b prefill layer (S 2000, P 64, N 128), the
    emulation's y and state, and the plain version's."""
    arrays = ssd_case(1, 4, 2000, 64, 128, seed=15)
    t = [_t(a) for a in arrays]
    y, h = ssd_tc_emulation(*t)
    want_y, want_h = ref.ssd_scan_ref(*t, return_state=True)
    return arrays, t, (y, h), (want_y, want_h)


def test_ssd_tc_arithmetic_within_phase_1c_limits(ssd_main):
    arrays, _, (y, h), (want_y, want_h) = ssd_main
    assert y.dtype == torch.float32 and bool(y.isfinite().all())
    assert max(chunk_errors(y, want_y)) < SSD_TOL
    assert _state_err(h, want_h) < SSD_TOL
    oracle = jref.ssd_scan_ref(*[jnp.asarray(a) for a in arrays])
    assert max(chunk_errors(y, oracle)) < SSD_TOL


def test_ssd_tc_arithmetic_matches_pallas_interpret(ssd_main):
    """Against the TPU kernel (chunk 256), interpreted on the CPU."""
    arrays, _, (y, _), _ = ssd_main
    kern = jops.ssd_scan(*[jnp.asarray(a) for a in arrays], chunk=256,
                         impl="interpret")
    assert max(chunk_errors(y, kern)) < SSD_TOL


def test_single_rounding_ssd_fails_phase_1c_limit(ssd_main):
    """The check can fail: the float32 operands (scores * dt, h, B * w dt)
    rounded once to bf16 miss the plain version by far more than 1e-4."""
    _, t, _, (want_y, _) = ssd_main
    y, _ = ssd_tc_emulation(*t, split=False)
    assert max(chunk_errors(y, want_y)) > 10 * SSD_TOL


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_ssd_tc_emulation_any_chunk_ragged(chunk):
    """The decomposition holds at any chunk length, S ragged included."""
    arrays = ssd_case(2, 3, 203, 16, 32, seed=chunk)
    t = [_t(a) for a in arrays]
    y, h = ssd_tc_emulation(*t, chunk=chunk)
    want_y, want_h = ref.ssd_scan_ref(*t, return_state=True)
    assert max(chunk_errors(y, want_y)) < SSD_TOL
    assert _state_err(h, want_h) < SSD_TOL


# -- dispatch ------------------------------------------------------------------

@pytest.mark.parametrize("op,dtype,module,entry", [
    ("flash_attention", torch.bfloat16, flash_attention_tc,
     "flash_attention_tc_cuda"),
    ("flash_attention", torch.float32, flash_attention_tc32,
     "flash_attention_tc32_cuda"),
    ("ssd_scan", torch.bfloat16, ssd_scan_tc, "ssd_scan_tc_cuda"),
    ("ssd_scan", torch.float32, ssd_scan_tc32, "ssd_scan_tc32_cuda"),
])
def test_dtype_dispatch_names_kernel_and_counter(op, dtype, module, entry):
    assert ops.cuda_kernel(op, dtype) is getattr(module, entry)
    assert ops.kernel_module(op, dtype) is module
    assert isinstance(module.launches, int)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    assert ops.kernel_module(op, other) is not module
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ops.cuda_kernel(op, torch.float16)


def test_tc_wrappers_refuse_what_they_do_not_take():
    """CPU tensors and other dtypes raise before anything is built."""
    q = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_tc.flash_attention_tc_cuda(
            q, q, q, causal=True, window=None, scale=1.0, t_actual=8)
    x = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16)
    dt = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_tc.ssd_scan_tc_cuda(x, dt, torch.zeros(2), x, x)
    assert flash_attention_tc.D_MAX == 256
    assert (ssd_scan_tc.N_MAX, ssd_scan_tc.P_MAX) == (128, 64)
