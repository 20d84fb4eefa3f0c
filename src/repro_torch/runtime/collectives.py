"""Explicit collectives over the named axes of a mesh.

The counterparts of ``repro.runtime.collectives``, whose functions run
inside ``shard_map`` over named mesh axes.  Here a mesh is one process per
card (``launch.mesh``), so each function takes this rank's local tensor and
runs ``torch.distributed`` collectives over the process group of the named
mesh dimension (``mesh.get_group(axis)``); ``mesh`` defaults to the one of
:func:`~repro_torch.runtime.sharding.use_rules`.  They compute values only
(no gradient flows through them), as the reference's are used.

The gradient-carrying reductions of the expert-parallel MoE and of the
loss under a mesh are the autograd functions at the end: :func:`psum`,
:func:`pmean` and :func:`replicated`.  Their backward is written for the
trainer's data-parallel mean: each data rank's gradient is its share of
the global gradient times the data-parallel size, so the mean over the
data axes (``hierarchical_pmean``) is the global gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .sharding import current_mesh

__all__ = ["hierarchical_pmean", "all_to_all_experts", "all_to_all_combine",
           "flash_decode_psum", "shard_map_moe_dispatch", "axis_groups",
           "psum", "pmean", "replicated"]


# the names torch gives these two since 2.12 (the older ones warn there)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _mesh(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass one, or run inside use_rules(rules, "
                         "mesh)")
    return mesh


def axis_groups(mesh, axes: str | Sequence[str]) -> list:
    """The process groups of the named mesh dimensions (this rank's)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return [_mesh(mesh).get_group(a) for a in axes]


def hierarchical_pmean(x: torch.Tensor, inner_axis: str,
                       outer_axis: str | None, mesh=None) -> torch.Tensor:
    """Two-level data-parallel mean of a flat tensor: a reduce-scatter over
    ``inner_axis``, an all-reduce of each piece over ``outer_axis``, an
    all-gather over ``inner_axis``, then a division by ``n_in * n_out``.
    ``x.numel()`` must divide by the inner axis' size."""
    mesh = _mesh(mesh)
    g_in = mesh.get_group(inner_axis)
    n_in = dist.get_world_size(g_in)
    flat = x.reshape(-1).contiguous()
    piece = flat.new_empty(flat.numel() // n_in)
    _reduce_scatter(piece, flat, group=g_in)
    n_out = 1
    if outer_axis is not None:
        g_out = mesh.get_group(outer_axis)
        dist.all_reduce(piece, group=g_out)
        n_out = dist.get_world_size(g_out)
    out = flat.new_empty(flat.numel())
    _all_gather(out, piece, group=g_in)
    return out / (n_in * n_out)


def all_to_all_experts(buf: torch.Tensor, axis: str,
                       mesh=None) -> torch.Tensor:
    """(E, cap, D) expert buffer: exchange so each rank holds its experts'
    tokens from every peer, (E/n, n*cap, D).  E must divide by the axis
    size."""
    group = _mesh(mesh).get_group(axis)
    n = dist.get_world_size(group)
    E, cap, D = buf.shape
    recv = torch.empty_like(buf).reshape(n, E // n, cap, D)
    dist.all_to_all_single(recv, buf.contiguous().reshape(n, E // n, cap, D),
                           group=group)
    return recv.permute(1, 0, 2, 3).reshape(E // n, n * cap, D)


def all_to_all_combine(buf: torch.Tensor, axis: str, E: int,
                       mesh=None) -> torch.Tensor:
    """Inverse of :func:`all_to_all_experts`: (E/n, n*cap, D) -> (E, cap,
    D)."""
    group = _mesh(mesh).get_group(axis)
    n = dist.get_world_size(group)
    e_loc, ncap, D = buf.shape
    cap = ncap // n
    send = buf.reshape(e_loc, n, cap, D).permute(1, 0, 2, 3).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.reshape(E, cap, D)


def flash_decode_psum(num: torch.Tensor, den: torch.Tensor, m: torch.Tensor,
                      axis: str, mesh=None) -> torch.Tensor:
    """Combine per-shard online-softmax partials across a KV-sharded axis.

    num: (..., d) unnormalized weighted values; den: (...,); m: (...,) local
    max.  Returns the exact softmax-weighted value as if KV were unsharded.
    """
    group = _mesh(mesh).get_group(axis)
    g_m = m.clone()
    dist.all_reduce(g_m, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - g_m)
    num = (num * corr[..., None]).contiguous()
    den = (den * corr).contiguous()
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    return num / torch.clamp(den, min=1e-30)[..., None]


def shard_map_moe_dispatch(xf, e_flat, g_flat, keep, pos_in_e, cap: int,
                           axis: str, n_experts: int, mesh=None):
    """Explicit-EP dispatch skeleton: this rank scatters its local tokens
    (T, D) into a full (E, cap, D) buffer (``keep``-ed assignments at
    ``e_flat * cap + pos_in_e``) and exchanges expert-major blocks, giving
    its own experts' buffer (E/n, n*cap, D).  ``g_flat`` is unused, as in
    the reference: the combine applies the gates."""
    T, D = xf.shape
    dest = torch.where(keep, e_flat * cap + pos_in_e,
                       torch.full_like(e_flat, n_experts * cap))
    tok = torch.arange(e_flat.shape[0], device=xf.device) // (
        e_flat.shape[0] // T)
    buf = xf.new_zeros((n_experts * cap + 1, D))
    buf[dest] = xf[tok]
    buf = buf[:-1].reshape(n_experts, cap, D)
    return all_to_all_experts(buf, axis, mesh)


# ---------------------------------------------------------------------------
# Reductions that carry gradients
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, groups) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    for g in groups:
        dist.all_reduce(out, group=g)
    return out


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, divide, grad_scale):
        ctx.grad_scale = grad_scale
        out = _all_reduce(x, groups)
        return out / divide if divide != 1 else out

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_scale != 1:
            g = g * ctx.grad_scale
        return g, None, None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups), None


def psum(x: torch.Tensor, groups, *, grad_scale: float = 1) -> torch.Tensor:
    """Sum over the ranks of ``groups`` (each group in turn).  Backward: the
    cotangent times ``grad_scale``.  The output is replicated over the
    groups and so is its cotangent: the transpose of the sum hands each
    rank the cotangent itself (scale 1: the MoE's combine over "model");
    a sum over the data axes takes the data-parallel size (the loss)."""
    return _Sum.apply(x, list(groups), 1, grad_scale)


def pmean(x: torch.Tensor, groups) -> torch.Tensor:
    """Mean over the ranks of ``groups`` (the data axes).  Backward: the
    cotangent itself, each rank's share (1/n of it) times the data-parallel
    size n."""
    groups = list(groups)
    n = 1
    for g in groups:
        n *= dist.get_world_size(g)
    return _Sum.apply(x, groups, n, 1)


def replicated(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` as it enters a computation each rank of ``groups`` does a part
    of (the MoE's experts over "model"): forward the identity, backward the
    sum of the ranks' partial cotangents."""
    return _Replicated.apply(x, list(groups))
