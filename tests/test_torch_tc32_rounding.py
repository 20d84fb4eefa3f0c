"""The arithmetic of the two float32 tensor-core kernels, emulated on the CPU.

``csrc/flash_attention_tc32.cu`` and ``csrc/ssd_scan_tc32.cu`` run only on
the card.  Their rounding does not: the emulations here repeat it in
PyTorch on float32 CPU tensors, so that the design is held to the float32
limits the card's checks use (``chip_smoke.py`` phases 1b and 1c) before it
reaches the card, and each check is shown to fail for the designs it rules
out.  Every product of the kernels has two float32 operands and runs as
three TF32 products: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi),
rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``'s
rounding, which the kernels compute as ``(bits + 0x1000) & ~0x1fff``), and
a.b = ah.bh + ah.bl + al.bh.  A product of two TF32 values is exact in
float32, as in ``mma.sync`` with float32 accumulation, so a float32 matmul
of TF32-valued operands repeats the card's products.

* attention: key tiles of 32 with the online softmax, the score scaled
  after Q.K^T, Q.K^T and P.V split; held at phase 1b's float32 limits
  (rtol = atol = 2e-5, q and k drawn at std 1.5) at both prefill shapes cut
  to a few heads, to the port's plain version and the JAX package's
  reference and Pallas kernel (in interpret mode).  One TF32 rounding of
  both operands fails those limits; a two-piece bf16 split of both stays
  inside them on these inputs but spends more than half of them.
* SSD scan: chunk-local states, the sequential pass over chunks and each
  chunk's output, at the kernel's chunk of 64, every product split; held
  at 1e-4 per 256-position chunk and for the final state to the plain
  version and the JAX package's oracle and Pallas kernel, with dt and A in
  Mamba-2's published ranges.  One TF32 rounding of the operands fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import (flash_attention, flash_attention_tc32, ops,
                                 ref, ssd_scan, ssd_scan_tc32)

NEG = -1e30
# phase 1b's float32 limits at the main shapes, and the std of q and k
ATTN_TOL, QK_STD = 2e-5, 1.5
# phase 1c's limit per SSD_CHECK_CHUNK positions and for the state
SSD_TOL, SSD_CHECK_CHUNK = 1e-4, 256
KEY_TILE = 32  # kBK of flash_attention_tc32.cu
SSD_CHUNK = ssd_scan_tc32.CHUNK


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits), nearest, ties
    away from zero, through the bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def product(a: torch.Tensor, b: torch.Tensor, mode: str = "split"):
    """a @ b as the kernels form it: ``"split"`` three TF32 products (the
    design); ``"tf32"`` one TF32 rounding of each operand; ``"bf16x2"`` each
    operand split into two bf16 parts, hi.hi + hi.lo + lo.hi."""
    if mode == "tf32":
        return tf32(a) @ tf32(b)
    rnd = tf32 if mode == "split" else _bf16
    ah, bh = rnd(a), rnd(b)
    al, bl = rnd(a - ah), rnd(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def test_tf32_rounding_is_the_cards():
    """cvt.rna.tf32.f32: nearest, ties away from zero, 13 low bits clear."""
    one = 1.0 + 2.0 ** -10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, one, 3.0e-30])
    got = tf32(x)
    assert got.tolist()[:4] == [one, -one, 1.0, one]
    assert not bool((got.view(torch.int32) & 0x1FFF).any())
    lo = tf32(x - got)  # hi + lo keeps 22 significant bits
    assert bool(((got + lo - x).abs() <= x.abs() * 2.0 ** -22).all())


# -- attention ---------------------------------------------------------------

def flash_tc32_emulation(q, k, v, *, causal=True, window=None, scale=None,
                         mode="split"):
    """flash_attention_tc32.cu's arithmetic: q (B,H,S,d), k/v (B,K,T,d)
    float32 -> (B,H,S,d) float32."""
    B, H, S, d = q.shape
    K, T = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    kf = k.repeat_interleave(H // K, dim=1)
    vf = v.repeat_interleave(H // K, dim=1)
    q_pos = torch.arange(S)[:, None]
    m = torch.full((B, H, S), NEG)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, d))
    for k0 in range(0, T, KEY_TILE):
        kt, vt = kf[:, :, k0:k0 + KEY_TILE], vf[:, :, k0:k0 + KEY_TILE]
        s = product(q, kt.transpose(-1, -2), mode) * scale
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
        acc = acc * alpha[..., None] + product(p, vt, mode)
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def attention_case(B, H, K, S, d, seed):
    """q, k at std QK_STD and v at std 0.4, float32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def mk(heads, std):
        return (rng.standard_normal((B, heads, S, d)) * std).astype(
            np.float32)
    return mk(H, QK_STD), mk(K, QK_STD), mk(K, 0.4)


def _outside(got, want) -> int:
    """Elements outside rtol = atol = ATTN_TOL (torch.isclose)."""
    w = torch.from_numpy(np.array(want, np.float32))
    return int((~torch.isclose(got, w, rtol=ATTN_TOL, atol=ATTN_TOL)).sum())


# the prefill shapes of phase 1b cut to a few heads: internlm2-1.8b's and
# recurrentgemma-2b's local attention
ATTN_MAIN = [(1, 4, 2, 2000, 128, None), (1, 2, 1, 2000, 256, 2048)]


@pytest.fixture(scope="module", params=ATTN_MAIN,
                ids=["internlm2-d128", "recurrentgemma-d256"])
def attn_main(request):
    B, H, K, S, d, window = request.param
    arrays = attention_case(B, H, K, S, d, seed=S + d)
    t = [torch.from_numpy(a) for a in arrays]
    plain = ref.flash_attention_ref(*t, causal=True, window=window)
    return arrays, t, window, plain


def test_flash_tc32_arithmetic_within_phase_1b_limits(attn_main):
    arrays, t, window, plain = attn_main
    got = flash_tc32_emulation(*t, window=window)
    assert got.dtype == torch.float32 and bool(got.isfinite().all())
    assert _outside(got, plain.numpy()) == 0
    oracle = jref.flash_attention_ref(*[jnp.asarray(a) for a in arrays],
                                      causal=True, window=window)
    assert _outside(got, oracle) == 0


def test_single_tf32_fails_phase_1b_limits(attn_main):
    """The check can fail: one TF32 rounding of each operand (11
    significant bits) moves most outputs past 2e-5 at q, k std 1.5."""
    _, t, window, plain = attn_main
    got = flash_tc32_emulation(*t, window=window, mode="tf32")
    assert _outside(got, plain.numpy()) > plain.numel() // 2


def test_two_piece_bf16_spends_most_of_the_limit(attn_main):
    """Each operand split into two bf16 parts (16 significant bits) stays
    inside 2e-5 on these inputs but spends more than half of it, where the
    TF32 split spends under a quarter: the margin the design keeps."""
    _, t, window, plain = attn_main
    err = {mode: float((flash_tc32_emulation(*t, window=window, mode=mode)
                        - plain).abs().max()) for mode in ("split", "bf16x2")}
    assert err["bf16x2"] > ATTN_TOL / 2 and err["split"] < ATTN_TOL / 4


def test_flash_tc32_arithmetic_matches_pallas_interpret():
    """Against the TPU kernel itself, interpreted on the CPU, at S 512."""
    q, k, v = attention_case(1, 2, 1, 512, 128, seed=7)
    got = flash_tc32_emulation(*[torch.from_numpy(a) for a in (q, k, v)])
    kern = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, q_block=256,
                                kv_block=256, impl="interpret")
    assert _outside(got, kern) == 0


# -- SSD scan ----------------------------------------------------------------

def ssd_tc32_emulation(x, dt, A, Bm, C, *, chunk=SSD_CHUNK, mode="split"):
    """ssd_scan_tc32.cu's three passes: x (B,H,S,P), Bm/C (B,H,S,N), dt
    (B,H,S) and A (H,), all float32 -> y (B,H,S,P), h (B,H,N,P)."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(t):  # (B,H,S,...) -> (B,H,nc,chunk,...), zeros past S
        if pad:
            t = torch.cat([t, t.new_zeros((B, H, pad) + t.shape[3:])], dim=2)
        return t.reshape((B, H, nc, chunk) + t.shape[3:])

    xc, bc, cc, dtc = chunks(x), chunks(Bm), chunks(C), chunks(dt)
    cum = torch.cumsum(dtc * A[None, :, None, None], dim=-1)
    last = cum[..., -1:]
    # (a) chunk-local states and decays
    u = torch.exp(last - cum) * dtc
    states = product((bc * u[..., None]).transpose(-1, -2), xc, mode)
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
    gram = product(cc, bc.transpose(-1, -2), mode)
    scores = torch.where(below, gram * torch.exp(diff) * dtc[..., None, :],
                         0.0)
    y = product(scores, xc, mode) + torch.exp(cum)[..., None] * product(
        cc, h_in, mode)
    return y.reshape(B, H, nc * chunk, P)[:, :, :S], h


def ssd_case(B, H, S, P, N, seed):
    """float32 x, Bm, C at std 1 (Bm and C one group over the heads, as in
    chip_smoke's prefill inputs); dt log-uniform in [1e-3, 1e-1] and A =
    -U[1, 16], Mamba-2's published ranges, as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, S, P)).astype(np.float32)
    bm = np.broadcast_to(rng.standard_normal((B, 1, S, N)).astype(
        np.float32), (B, H, S, N)).copy()
    c = np.broadcast_to(rng.standard_normal((B, 1, S, N)).astype(
        np.float32), (B, H, S, N)).copy()
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
    """4 heads of a mamba2-2.7b prefill layer (S 2000, P 64, N 128) in
    float32, and the plain version's y and state."""
    arrays = ssd_case(1, 4, 2000, 64, 128, seed=16)
    t = [torch.from_numpy(a) for a in arrays]
    want = ref.ssd_scan_ref(*t, return_state=True)
    return arrays, t, want


def test_ssd_tc32_arithmetic_within_phase_1c_limits(ssd_main):
    arrays, t, (want_y, want_h) = ssd_main
    y, h = ssd_tc32_emulation(*t)
    assert y.dtype == torch.float32 and bool(y.isfinite().all())
    assert max(chunk_errors(y, want_y)) < SSD_TOL
    assert _state_err(h, want_h) < SSD_TOL
    oracle = jref.ssd_scan_ref(*[jnp.asarray(a) for a in arrays])
    assert max(chunk_errors(y, oracle)) < SSD_TOL
    kern = jops.ssd_scan(*[jnp.asarray(a) for a in arrays], chunk=256,
                         impl="interpret")
    assert max(chunk_errors(y, kern)) < SSD_TOL


def test_single_tf32_ssd_fails_phase_1c_limit(ssd_main):
    """The check can fail: every operand rounded once to TF32 misses the
    plain version by several times 1e-4."""
    _, t, (want_y, _) = ssd_main
    y, _ = ssd_tc32_emulation(*t, mode="tf32")
    assert max(chunk_errors(y, want_y)) > 3 * SSD_TOL


@pytest.mark.parametrize("P,N", [(33, 16), (64, 4)])
def test_ssd_tc32_emulation_ragged_and_narrow(P, N):
    """An odd P, a narrow state and a ragged last chunk (S 203)."""
    arrays = ssd_case(2, 3, 203, P, N, seed=P + N)
    t = [torch.from_numpy(a) for a in arrays]
    y, h = ssd_tc32_emulation(*t)
    want_y, want_h = ref.ssd_scan_ref(*t, return_state=True)
    assert max(chunk_errors(y, want_y)) < SSD_TOL
    assert _state_err(h, want_h) < SSD_TOL


# -- dispatch ------------------------------------------------------------------

@pytest.mark.parametrize("module", [flash_attention, ssd_scan])
def test_comparators_are_on_no_path(module):
    """The earlier CUDA-core float32 kernels serve no dtype: ops dispatches
    float32 to the tensor-core kernels, and no serving path launches the
    comparators."""
    op = module.__name__.rsplit(".", 1)[-1]
    for dtype in (torch.float32, torch.bfloat16):
        assert ops.kernel_module(op, dtype) is not module
    assert ops.kernel_module(op, torch.float32) in (flash_attention_tc32,
                                                     ssd_scan_tc32)
