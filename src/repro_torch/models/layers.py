"""Shared primitive layers: norms, RoPE, gated MLPs.

The counterpart of ``repro.models.layers`` for the dense family, with the
reference's cast points: norms and RoPE compute in float32 and return the
input's dtype.  The reference's ``mxu_einsum`` (bf16 operands, f32
accumulation on the TPU) becomes :func:`f32_einsum`, its runnable form:
both operands upcast to float32.  :func:`gelu_tanh` is
``jax.nn.gelu(approximate=True)`` as the reference runs it: operation by
operation in the input's dtype.  :func:`causal_conv1d` serves the SSM and
RG-LRU families; :func:`sinusoidal_positions` is Whisper's position
table (both of its stacks), in float32 like the reference's.

Under the tensor-parallel rules (training and serving) :func:`mlp` is
the reference's partition of it: ``wi``/``wg`` column-parallel and ``wo``
row-parallel over "model" (:mod:`~repro_torch.runtime.partition`); on a
stream split along its positions its region gathers them at its entry and
reduce-scatters at its exit (sequence parallelism), and without tensor
parallelism it runs on the rank's positions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..runtime.partition import (UNIT, enter, leave, seq_gather, seq_scatter,
                                 sequence_parallel, tp_axis)

__all__ = ["rms_norm", "rope", "sinusoidal_positions", "gelu_tanh",
           "apply_act", "mlp", "f32_einsum", "causal_conv1d", "conv_carry"]


def f32_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product with float32 operands and result (the reference's
    ``mxu_einsum`` as it runs off the TPU)."""
    return torch.einsum(spec, a.float(), b.float())


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding on the last axis.

    x: (..., S, H, d) with d even; positions: (S,) or (B, S).
    """
    d = x.shape[-1]
    dt = x.dtype
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)          # (d/2,)
    angles = positions.float()[..., None] * freqs                  # (..., S, d/2)
    angles = angles[..., None, :]  # broadcast over the head axis
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Transformer sinusoidal table for arbitrary positions (Whisper):
    (..., d_model) float32, sines then cosines.  Callers cast it to the
    activations' dtype before adding it, as the reference does.  The
    frequencies are the float32 exponents' powers rounded once from
    float64: XLA's float32 power is correctly rounded there and
    PyTorch's is not always (an ulp of a frequency is an ulp of the
    angle times the position, 1e-4 at position 1500)."""
    pos = positions.float()
    expo = -torch.arange(0, d_model, 2, dtype=torch.float32,
                         device=positions.device) / d_model
    inv = (10000.0 ** expo.double()).float()
    ang = pos[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU with the reference's rounding: each
    operation in x's dtype, the constants rounded to it first (what
    ``jax.nn.gelu(approximate=True)`` does; ``F.gelu(approximate="tanh")``
    rounds once from float32 and differs by a bf16 ulp).  The constants
    are 0-dim CPU tensors, so a CUDA ``x`` takes them as scalars with no
    host-to-device copy."""
    def k(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=x.dtype)
    inner = k(math.sqrt(2 / math.pi)) * (x + k(0.044715) * x ** 3)
    return x * (k(0.5) * (k(1.0) + torch.tanh(inner)))


def apply_act(h: torch.Tensor, g: torch.Tensor | None,
              act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(g) * h if g is not None else F.silu(h)
    if act == "geglu":
        return gelu_tanh(g) * h if g is not None else gelu_tanh(h)
    if act == "gelu":
        return gelu_tanh(h)
    raise ValueError(f"unknown activation {act!r}")


def mlp(params, x: torch.Tensor, act: str, *,
        d_ff: int | None = None, sq=UNIT) -> torch.Tensor:
    """(Gated) feed-forward block; params: wi, wo [, wg] [, bi, bo].  When
    ``wi`` holds this model rank's block of ``d_ff`` columns (under tensor
    parallelism), a region: ``wi``/``wg`` column-parallel,
    ``wo`` row-parallel, the partial products summed over "model".  ``sq``:
    the axis ``x`` is split over along its positions (a region's
    boundaries then gather and reduce-scatter them; whole weights under
    sequence parallelism run on the whole sequence)."""
    ax = UNIT if d_ff is None else tp_axis(params["wi"].shape[-1], d_ff, sq)
    if ax.n == 1 and sequence_parallel(sq):
        return seq_scatter(mlp(params, seq_gather(x, sq), act, d_ff=d_ff),
                           sq)
    x = enter(x, ax)
    h = x @ params["wi"]
    if "bi" in params:
        h = h + params["bi"]
    g = (x @ params["wg"]) if "wg" in params else None
    h = apply_act(h, g, act)
    o = leave(h @ params["wo"], ax)
    if "bo" in params:
        o = o + params["bo"]
    return o


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal 1-D conv.

    x: (B, S, C); w: (K, C).  Returns (y, new_state) where state is the last
    (K-1) inputs -- the decode carry.  When ``state`` is given, x is the new
    chunk (decode: S == 1) and the conv sees [state, x].  The window sum is
    float32; y and the state come back in x's dtype.
    """
    k = w.shape[0]
    if state is not None:
        xx = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        xx = F.pad(x, (0, 0, k - 1, 0))
    # windowed sum: y[t] = sum_j w[j] * xx[t + j]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        y = y + xx[:, j:j + x.shape[1], :].float() * w[j].float()
    return y.to(x.dtype), _carry(xx, k).to(x.dtype)


def _carry(xx: torch.Tensor, k: int) -> torch.Tensor:
    return (xx[:, -(k - 1):, :] if k > 1
            else xx.new_zeros((xx.shape[0], 0, xx.shape[2])))


def conv_carry(x: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`causal_conv1d`'s carry of a whole sequence x (B, S, C) for a
    ``k``-tap conv: its last k - 1 inputs, zeros before the start."""
    return _carry(F.pad(x, (0, 0, k - 1, 0)), k)
