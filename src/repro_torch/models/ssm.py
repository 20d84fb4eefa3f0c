"""Mamba-2 block: state-space duality (SSD).

The counterpart of ``repro.models.ssm``, cast for cast.  The reference's
model path runs :func:`ssd_chunked` (XLA); here the prefill's scan is the
``ssd_scan`` kernel (:func:`repro_torch.kernels.ops.ssd_scan`: the CUDA
kernel for CUDA tensors, its plain sequential version for CPU tensors),
which also returns the final state for the decode cache.  One intended
difference follows: :func:`ssd_chunked` rounds ``xdt`` and the scores to
the input dtype (bf16 on the model path) before its products, as the
reference does; the kernel, like the TPU kernel, computes in float32.
Training runs :func:`ssd_chunked` itself (``mamba2_forward(...,
train=True)``), the reference's own math with those roundings: autograd
differentiates it, and the kernel has no backward (nor has the TPU
kernel).  It is also the oracle of the chunked form and the time to
compare the kernel with.

Block structure (Mamba-2):
    in_proj -> [z | xBC | dt]; causal depthwise conv on xBC; SSD(x, dt, A, B, C)
    -> gated RMSNorm(y * silu(z)) -> out_proj; +D*x skip per head.

Under the tensor-parallel rules (training and serving) the fused
``in_proj``'s columns are split over "model" as one block of z | xBC | dt,
which straddles the parts: its output is gathered over "model", and each
rank runs its own heads of x, z and dt (B and C whole), the gated norm's
sum of squares all-reduced, and ``out_proj`` row-parallel over its heads'
rows.  The decode state ``h`` is the rank's heads; the conv carry, which
the reference's layout replicates, is every channel's, from the gathered
projection.  In training on a stream split along its positions
(sequence parallelism) the region's entry gathers them, so the conv and
the scan run on the whole sequence of the rank's heads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..runtime.partition import (UNIT, enter, gather, leave, psum_region,
                                 tp_axis, whole)
from ..runtime.sharding import note
from .layers import causal_conv1d, conv_carry, f32_einsum, rms_norm

__all__ = ["ssd_chunked", "ssd_step", "mamba2_forward", "mamba2_decode_step"]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j<m<=i} a[..., m].

    a: (..., L) -> (..., L, L); entries above the diagonal are -1e30.
    """
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # (..., i, j) = cs_i - cs_j
    mask = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, -1e30)


def ssd_chunked(x, dt, A, Bm, C, *, chunk: int, h0=None):
    """Chunked SSD in plain torch.

    x:  (B, S, H, P)   inputs per head
    dt: (B, S, H)      positive step sizes (already softplus'ed)
    A:  (H,)           negative decay rates
    Bm: (B, S, H, N)   input->state projection (already head-broadcast)
    C:  (B, S, H, N)   state->output projection
    h0: optional initial state (B, H, N, P)
    Returns (y (B,S,H,P) f32, h_final (B,H,N,P) f32).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S

    def padc(t):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))

    # matmul operands stay in the input dtype (bf16 on the model path);
    # decay/cumsum math and the carried state are f32.
    xf = padc(x).reshape(Bsz, nc, L, H, P)
    dtf = padc(dt).float().reshape(Bsz, nc, L, H)
    Bf = padc(Bm).reshape(Bsz, nc, L, H, N)
    Cf = padc(C).reshape(Bsz, nc, L, H, N)

    a = dtf * A.float()[None, None, None, :]               # (B,nc,L,H) log-decay
    a_t = a.permute(0, 1, 3, 2)                            # (B,nc,H,L)
    cum = torch.cumsum(a_t, dim=-1)                        # inclusive
    xdt = (xf.float() * dtf[..., None]).to(x.dtype)

    # -- intra-chunk (quadratic within L, matmul-friendly) ---------------------
    Lmat = torch.exp(_segsum(a_t))                          # (B,nc,H,L,L)
    scores = f32_einsum("bclhn,bcmhn->bchlm", Cf, Bf) * Lmat
    y_intra = f32_einsum("bchlm,bcmhp->bclhp", scores.to(x.dtype), xdt)

    # -- chunk states -----------------------------------------------------------
    decay_to_end = torch.exp(cum[..., -1:] - cum)           # (B,nc,H,L)
    states = torch.einsum("bclhn,bchl,bclhp->bchnp", Bf.float(),
                          decay_to_end, xdt.float())

    # -- inter-chunk recurrence over nc (tiny sequential scan) -------------------
    chunk_decay = torch.exp(cum[..., -1])                   # (B,nc,H)
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)                                      # state entering chunk
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                         # (B,nc,H,N,P)

    # -- contribution of the incoming state -----------------------------------------
    decay_from_start = torch.exp(cum)                       # (B,nc,H,L)
    y_inter = torch.einsum("bclhn,bchl,bchnp->bclhp", Cf.float(),
                           decay_from_start, h_in)

    y = (y_intra + y_inter).reshape(Bsz, nc * L, H, P)[:, :S]
    return y, h


def ssd_step(h, x_t, dt_t, A, B_t, C_t):
    """Single decode step.  h: (B,H,N,P); x_t: (B,H,P); dt_t: (B,H);
    B_t/C_t: (B,H,N).  Returns (y_t (B,H,P), h')."""
    da = torch.exp(dt_t.float() * A.float()[None, :])
    h = h * da[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", B_t.float(), (x_t * dt_t[..., None]).float())
    y = torch.einsum("bhn,bhnp->bhp", C_t.float(), h)
    return y, h


def _split_zxbcdt(cfg, zxbcdt):
    d_in, N, G, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_heads
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in: 2 * d_in + 2 * G * N]
    dt = zxbcdt[..., 2 * d_in + 2 * G * N:]
    assert dt.shape[-1] == H
    return z, xBC, dt


def _split_xbc(cfg, xBC):
    d_in, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    x = xBC[..., :d_in]
    Bm = xBC[..., d_in: d_in + G * N]
    C = xBC[..., d_in + G * N:]
    return x, Bm, C


def _broadcast_groups(cfg, t):
    """(B,S,G*N) -> (B,S,H,N) by repeating each group over its heads: a
    view with a head stride of 0 when there is one group."""
    B, S, _ = t.shape
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    t = t.reshape(B, S, G, 1, N)
    t = t.expand(B, S, G, H // G, N)
    return t.reshape(B, S, H, N)


def mamba2_forward(cfg, p, x, *, return_state=False, train=False, sq=UNIT):
    """Full-sequence Mamba-2 block.  x: (B,S,D) -> (B,S,D); with
    ``return_state`` also ``(h_last (B,H,N,P) f32, conv_state)``, the
    decode carry.  The scan is the ``ssd_scan`` kernel, which reads x, Bm
    and C as views of the conv output (no copies) and writes y in the
    (B,S,H,P) layout; with ``train`` it is :func:`ssd_chunked` at
    ``cfg.ssm_chunk``, which autograd differentiates.

    Under tensor parallelism (``out_proj`` holding this model rank's rows)
    the block is a region over "model" on the rank's heads [a, b):
    ``in_proj``'s block of columns is multiplied and gathered (or, held
    whole, multiplied whole); the rank's heads of x, z and dt, and B and C
    whole, go through the conv and the scan; the gated norm's variance
    sums the ranks' squares; ``out_proj``'s rows take their channels.
    Where the heads do not divide over "model" every head is computed here
    and ``out_proj``'s rows take their columns.  Otherwise the region is
    ``UNIT``'s: every head, the plain computation.  The returned state is
    the rank's heads, and the conv carry every channel's.  ``sq``: the
    axis ``x`` is split over along its positions, which the region's
    boundaries gather and reduce-scatter (sequence parallelism)."""
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    d_in = cfg.d_inner
    ax = tp_axis(p["out_proj"].shape[0], d_in, sq)
    hin = enter(x, ax)
    B, S, D = hin.shape
    w = p["in_proj"]
    if ax.split(w.shape[-1], 2 * d_in + 2 * G * N + H):
        if ax.n > 1:
            note("ssm/in_proj", f"in_proj's z | xBC | dt block on model="
                 f"{ax.n} straddles its parts: its output gathered over "
                 "'model'")
        zxbcdt = gather(hin @ w, -1, ax)
    else:
        zxbcdt = hin @ whole(w, ax)
    z, xBC, dt = _split_zxbcdt(cfg, zxbcdt)
    if H % ax.n:
        note("ssm/heads", f"{H} heads on model={ax.n}: every head computed "
             "on each rank")
        a, b = 0, H
    else:
        a, b = ax.block(H)
    c0, c1 = a * P, b * P
    conv_w = whole(p["conv_w"], ax)
    new_conv = None
    if b - a < H:  # this rank's channels of x, then B and C
        if return_state:  # the carry of every channel
            new_conv = conv_carry(xBC, cfg.ssm_conv)
        xBC = torch.cat([xBC[..., c0:c1], xBC[..., d_in:]], dim=-1)
        conv_w = torch.cat([conv_w[:, c0:c1], conv_w[:, d_in:]], dim=-1)
    xBC, carry = causal_conv1d(xBC, conv_w)
    new_conv = carry if new_conv is None else new_conv
    xBC = F.silu(xBC)
    nl = c1 - c0
    xs = xBC[..., :nl].reshape(B, S, b - a, P)
    Bm = _broadcast_groups(cfg, xBC[..., nl:nl + G * N])[:, :, a:b]
    C = _broadcast_groups(cfg, xBC[..., nl + G * N:])[:, :, a:b]
    dt = F.softplus(dt[..., a:b].float()
                    + whole(p["dt_bias"], ax)[a:b].float())
    A = -torch.exp(whole(p["A_log"], ax)[a:b].float())
    if train:
        y, h_last = ssd_chunked(xs, dt, A, Bm, C, chunk=cfg.ssm_chunk)
    else:
        y, h_last = ops.ssd_scan(xs.transpose(1, 2), dt.transpose(1, 2), A,
                                 Bm.transpose(1, 2), C.transpose(1, 2),
                                 return_state=True)
        y = y.transpose(1, 2)                               # (B,S,H,P)
    y = y + xs.float() * whole(p["D"], ax)[a:b].float()[None, None, :, None]
    y = y.reshape(B, S, nl).to(x.dtype)
    y = y * F.silu(z[..., c0:c1])
    scale = whole(p["norm"], ax)[c0:c1]
    if b - a == H:  # every channel here: the gated norm as it is
        y = rms_norm(y, scale, cfg.norm_eps)
    else:  # the variance over all d_inner channels, summed over "model"
        yf = y.float()
        var = psum_region(yf.square().sum(dim=-1, keepdim=True), ax) / d_in
        y = (yf * torch.rsqrt(var + cfg.norm_eps)
             * (1.0 + scale.float())).to(y.dtype)
    wo = p["out_proj"]
    if nl != wo.shape[0]:
        lo, hi = ax.block(d_in)
        y = y[..., lo - c0:hi - c0]
    out = leave(y @ wo, ax)
    if return_state:
        return out, (h_last, new_conv)
    return out


def mamba2_decode_step(cfg, p, x, h, conv_state):
    """One-token step.  x: (B,1,D); h: (B,H,N,P); conv_state:
    (B,K-1,convdim).  Under tensor parallelism the in_proj output is
    gathered and the conv runs on every channel (its carry replicated),
    then the step on this rank's heads ``h`` (B,Hl,N,P), the gated norm's
    variance summed over "model" and ``out_proj`` row-parallel."""
    B = x.shape[0]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    d_in = cfg.d_inner
    ax = tp_axis(p["out_proj"].shape[0], d_in)
    hin = enter(x, ax)
    w = p["in_proj"]
    if ax.split(w.shape[-1], 2 * d_in + 2 * G * N + H):
        zxbcdt = gather(hin @ w, -1, ax)
    else:
        zxbcdt = hin @ whole(w, ax)
    z, xBC, dt = _split_zxbcdt(cfg, zxbcdt)
    xBC, conv_state = causal_conv1d(xBC, whole(p["conv_w"], ax), conv_state)
    xBC = F.silu(xBC)
    xs, Bm, C = _split_xbc(cfg, xBC)
    a, b = (0, H) if H % ax.n else ax.block(H)
    c0, c1 = a * P, b * P
    xs = xs[..., c0:c1].reshape(B, b - a, P)
    Bm = _broadcast_groups(cfg, Bm)[:, 0, a:b]
    C = _broadcast_groups(cfg, C)[:, 0, a:b]
    dt = F.softplus(dt[..., a:b].float()
                    + whole(p["dt_bias"], ax)[a:b].float())[:, 0]
    A = -torch.exp(whole(p["A_log"], ax)[a:b].float())
    y, h = ssd_step(h, xs, dt, A, Bm, C)
    y = y + xs.float() * whole(p["D"], ax)[a:b].float()[None, :, None]
    y = y.reshape(B, 1, c1 - c0).to(x.dtype)
    y = y * F.silu(z[..., c0:c1])
    scale = whole(p["norm"], ax)[c0:c1]
    if b - a == H:
        y = rms_norm(y, scale, cfg.norm_eps)
    else:  # the variance over all d_inner channels, summed over "model"
        yf = y.float()
        var = psum_region(yf.square().sum(dim=-1, keepdim=True), ax) / d_in
        y = (yf * torch.rsqrt(var + cfg.norm_eps)
             * (1.0 + scale.float())).to(y.dtype)
    wo = p["out_proj"]
    if c1 - c0 != wo.shape[0]:
        lo, hi = ax.block(d_in)
        y = y[..., lo - c0:hi - c0]
    return leave(y @ wo, ax), h, conv_state
