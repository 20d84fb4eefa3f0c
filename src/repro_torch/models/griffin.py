"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The counterpart of ``repro.models.griffin``, cast for cast.  The gated
linear recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is
elementwise, so the gates (which depend only on x_t) come from two float32
matrix products (TF32 off: :func:`repro_torch.convert.exact_float32`), and
the recurrence itself is the ``rg_lru`` kernel
(:func:`repro_torch.kernels.ops.rg_lru_scan`: the CUDA kernel for CUDA
tensors, its plain sequential version for CPU tensors).  The reference's
model path runs an associative scan in XLA instead and never calls its
kernel; both compute the same recurrence.  Training runs
:func:`linear_scan`, that associative scan's ``combine`` in plain torch
and in log-depth, which autograd differentiates (the kernel has no
backward, nor has the TPU kernel).

Block structure (Griffin recurrent block):
    norm -> { y = gelu(x @ wy) ; r = rglru(conv1d(x @ wx)) } -> (y * r) @ wo

Under the tensor-parallel rules (training and serving) ``wx``/``wy`` and
the gates' ``w_i``/``w_r`` are column-parallel over "model" and ``wo``
row-parallel: each rank runs the recurrence (and the decode step) on its
channels, whose state and conv carry are its blocks of the cache, and its
gate columns read the whole conv output, gathered over "model".  In
training on a stream split along its positions (sequence parallelism)
the region's entry gathers them: the conv and the recurrence run on the
whole sequence of the rank's channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..runtime.partition import UNIT, enter, gather, leave, tp_axis, whole
from ..runtime.sharding import note
from .layers import causal_conv1d, gelu_tanh

__all__ = ["linear_scan", "rg_lru", "rg_lru_step", "griffin_forward",
           "griffin_decode_step"]

_C = 8.0  # Griffin's fixed gate sharpness


def _gates(p, x):
    """i_t, log_a_t from x (B,S,W); all float32.  ``w_i`` and ``w_r`` are
    upcast on every call, as in the reference."""
    xf = x.float()
    i_t = torch.sigmoid(xf @ p["w_i"].float() + p["b_i"].float())
    r_t = torch.sigmoid(xf @ p["w_r"].float() + p["b_r"].float())
    # a_t = exp(-c * softplus(Lambda) * r_t)  -> log_a in (-inf, 0)
    log_a = -_C * F.softplus(p["lam"].float()) * r_t
    return i_t, log_a


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0 along axis 1 of (B,S,W),
    in ceil(log2 S) levels: at the level of stride d every position
    combines the prefix d before it with its own by the reference's
    ``combine(l, r) = (a_l * a_r, b_l * a_r + b_r)``, the positions before
    the start taking the identity (1, 0).  Out of place (padding, never
    slice assignment), so autograd differentiates it."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = F.pad(b[:, :-d], (0, 0, d, 0)) * a + b
        if 2 * d < S:  # the last level needs no products of a
            a = F.pad(a[:, :-d], (0, 0, d, 0), value=1.0) * a
        d *= 2
    return b


def rg_lru(p, x, h0=None, *, train=False, gate_x=None):
    """x: (B,S,W) -> (y (B,S,W) f32, h_last (B,W) f32) through the
    ``rg_lru`` kernel, or with ``train`` through :func:`linear_scan`; a
    given ``h0`` is folded into the first step's additive term, as the
    reference does.  ``gate_x``: the gates' input where it is not ``x``
    (every channel, for this model rank's channels ``x``)."""
    i_t, log_a = _gates(p, x if gate_x is None else gate_x)
    a = torch.exp(log_a)
    gate = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    b = gate * i_t * x.float()
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = linear_scan(a, b) if train else ops.rg_lru_scan(a, b)
    return h, h[:, -1]


def rg_lru_step(p, x_t, h, *, gate_x=None):
    """One step.  x_t: (B,1,W); h: (B,W); ``gate_x``: the gates' input
    where it is not ``x_t``, as :func:`rg_lru`'s."""
    i_t, log_a = _gates(p, x_t if gate_x is None else gate_x)
    a = torch.exp(log_a[:, 0])
    gate = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    h = a * h.float() + gate * (i_t[:, 0] * x_t[:, 0].float())
    return h[:, None, :], h


def griffin_forward(cfg, p, x, *, return_state=False, train=False, sq=UNIT):
    """Full-sequence recurrent block.  x: (B,S,D) -> (B,S,D); with
    ``return_state`` also ``(h_last (B,W) f32, conv_state)``, the decode
    carry; ``train`` runs the recurrence through :func:`linear_scan`.
    Under tensor parallelism (``wx`` holding this model rank's columns) a
    region over "model" on the rank's channels [c0, c1) of the recurrence,
    its state and conv carry those channels'; otherwise ``UNIT``'s, every
    channel.  ``sq``: the axis ``x`` is split over along its positions,
    which the region's boundaries gather and reduce-scatter (sequence
    parallelism)."""
    ax = tp_axis(p["wx"].shape[-1], cfg.lru, sq)
    c0, c1 = ax.block(cfg.lru)
    hin = enter(x, ax)
    y_branch = gelu_tanh(hin @ p["wy"])
    r, new_conv = causal_conv1d(hin @ p["wx"],
                                whole(p["conv_w"], ax)[:, c0:c1])
    if ax.n > 1:
        note("rglru/gates", f"the gates' columns on model={ax.n} read every "
             "channel: the conv output gathered over 'model'")
    gp = {"w_i": p["w_i"], "w_r": p["w_r"],
          **{k: whole(p[k], ax)[c0:c1] for k in ("b_i", "b_r", "lam")}}
    r_out, h_last = rg_lru(gp, r, train=train, gate_x=gather(r, -1, ax))
    out = leave((y_branch.float() * r_out).to(x.dtype) @ p["wo"], ax)
    if return_state:
        return out, (h_last, new_conv)
    return out


def griffin_decode_step(cfg, p, x, h, conv_state):
    """One-token step.  x: (B,1,D); h: (B,W); conv_state: (B,K-1,W): under
    tensor parallelism this rank's channels [c0, c1) of both, its gates
    from the token's conv output gathered over "model"."""
    ax = tp_axis(p["wx"].shape[-1], cfg.lru)
    c0, c1 = ax.block(cfg.lru)
    hin = enter(x, ax)
    y_branch = gelu_tanh(hin @ p["wy"])
    r = hin @ p["wx"]
    r, conv_state = causal_conv1d(r, whole(p["conv_w"], ax)[:, c0:c1],
                                  conv_state)
    gp = {"w_i": p["w_i"], "w_r": p["w_r"],
          **{k: whole(p[k], ax)[c0:c1] for k in ("b_i", "b_r", "lam")}}
    r_out, h = rg_lru_step(gp, r, h, gate_x=gather(r, -1, ax))
    out = leave((y_branch.float() * r_out).to(x.dtype) @ p["wo"], ax)
    return out, h, conv_state
