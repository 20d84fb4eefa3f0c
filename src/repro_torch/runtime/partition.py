"""Tensor parallelism and FSDP on a mesh: the explicit counterparts of
what GSPMD inserts into the reference's train, prefill and decode steps.

Under the training rules and under the serving rules (``serve_rules``,
their ``/wsharded`` form included) each rank holds the reference's block of
every parameter (:func:`~.sharding.explicit_spec`, which is
``logical_to_spec``): its "fsdp" dimension over the data axes (over every
axis under ``tp=False``; over "data" for the ``/wsharded`` serving rules,
none for the others), its tensor-parallel dimensions ("heads", "kv_heads",
"qkv", "ff", "vocab", "state" and the routed experts' "experts") over
"model".  The step computes on those blocks:

* FSDP.  Before a layer runs, :func:`gather_block` all-gathers each of its
  parameters over every mesh axis of its block but the tensor-parallel
  ones (:func:`gather_plan`): the router's "experts" too, as the
  expert-parallel MoE reads the whole router.  The model code calls it
  inside each remat unit in training, so the backward gathers again
  instead of keeping whole weights; its backward reduce-scatters the
  cotangent as a mean over the gathered axes.  Prefill and decode gather
  each layer's blocks before the layer, with no autograd.
* Tensor parallelism.  A module whose weights hold this rank's block over
  "model" runs on it: a *region* begins with :func:`enter` (the identity;
  backward, the sum of the model ranks' partial cotangents) and ends with
  :func:`leave` (the sum of the ranks' partial results; backward, the
  identity) -- Megatron's f and g.  Inside a region the cotangent a rank
  holds is its part of the whole one, so a tensor gathered over "model"
  there (:func:`gather`) takes back the sum of the parts in its backward,
  a whole weight used there enters the region too, and a sum that the
  region's ranks read (:func:`psum_region`) sums both ways.  Where a block
  does not align with what the math needs (a kv head split across ranks,
  Mamba-2's fused projection), the module gathers the activation over
  "model" as GSPMD would, and records it once in ``sharding_report()``.
  Each module has one forward: off the mesh, or where its weights are
  whole, it runs its region on :data:`UNIT` (:func:`tp_axis`), where every
  collective is skipped and the region is the plain computation.
* A decode cache split over "model" along its positions ("cache_seq"
  under ``serve_rules(kv_shard="seq")``): :func:`cache_seq_block` gives
  this rank's positions, and attention over them is a partial that
  :func:`~.collectives.flash_decode_psum` combines.

Gradients.  The loss's cross-entropy sum enters its all-reduce over the
batch axes with the data-parallel size as gradient scale
(:func:`~.collectives.psum`), so a rank's gradient is its share of the
global one times that size.  The trainer then takes, per tensor, the mean
over the batch axes its block's gather did not already reduce over
(:func:`reduction_axes`): ``Σ over them / their size`` after the gather's
mean gives the global gradient, for every table of ``train_rules``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from .collectives import _all_gather, _reduce_scatter, psum, replicated
from .sharding import (PartitionSpec, ShardingRules, batch_axes,
                       current_mesh, current_rules, explicit_spec,
                       mesh_coords, mesh_shape)

__all__ = ["TP_LOGICAL", "ModelAxis", "UNIT", "model_axis", "tp_axis",
           "tp_kept", "cache_seq_block",
           "gather_plan", "block_plans", "gather_block", "reduction_axes",
           "enter", "leave", "gather", "psum_region", "all_reduce_max"]

# the logical axes a tensor-parallel block keeps split over "model"
TP_LOGICAL = frozenset({"heads", "kv_heads", "qkv", "ff", "vocab", "state",
                        "experts"})

Plan = tuple[tuple[int, tuple[str, ...]], ...]


def _as_tuple(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def tp_kept(axes: Sequence[str | None], i: int) -> bool:
    """Whether dimension ``i`` of a parameter with logical ``axes`` stays
    split in the step (a tensor-parallel dimension) instead of being
    gathered before use: a name of :data:`TP_LOGICAL`, "experts" only where
    it leads the tensor (the routed experts; the router's is gathered)."""
    if axes[i] == "experts":
        return i == next(j for j, a in enumerate(axes) if a != "layers")
    return axes[i] in TP_LOGICAL


def gather_plan(axes: Sequence[str | None], spec: PartitionSpec) -> Plan:
    """``(dim, mesh axes)`` of each dimension of a parameter's block that
    the step gathers before use: every sharded one but the
    tensor-parallel ones."""
    parts = tuple(spec) + (None,) * (len(axes) - len(spec))
    return tuple((i, _as_tuple(p)) for i, p in enumerate(parts)
                 if p is not None and not tp_kept(axes, i))


def block_plans(specs: Mapping[str, Any], rules: ShardingRules,
                mesh) -> dict[str, Plan]:
    """:func:`gather_plan` of every parameter of ``specs`` (name ->
    ``ParamSpec``) under ``rules`` on ``mesh``."""
    return {k: gather_plan(s.axes, explicit_spec(s.axes, s.shape, rules,
                                                 mesh, context=k))
            for k, s in specs.items()}


def reduction_axes(plan: Plan, mesh, rules) -> tuple[str, ...]:
    """The batch axes a parameter's gradient is still averaged over after
    its gather's backward: those its plan does not gather over."""
    done = {a for _, axes in plan for a in axes}
    return tuple(a for a in batch_axes(mesh, rules) if a not in done)


# -- collectives with their duals as backward ---------------------------------

def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    _all_gather(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter_dim(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return g
    gt = g.movedim(dim, 0).contiguous()
    out = gt.new_empty((gt.shape[0] // n, *gt.shape[1:]))
    _reduce_scatter(out, gt, group=group)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``groups`` (a dimension sharded over
    several axes is laid out row-major over them, so the innermost is
    gathered first); backward the reduce-scatter, divided by the groups'
    size when ``mean``."""

    @staticmethod
    def forward(ctx, x, dim, groups, mean):
        ctx.dim, ctx.groups, ctx.mean = dim, groups, mean
        out = x
        for g in reversed(groups):
            out = _gather_dim(out, dim, g)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        n = 1
        for grp in ctx.groups:
            g = _scatter_dim(g, ctx.dim, grp)
            n *= dist.get_world_size(grp)
        if ctx.mean and n > 1:
            g = g / n
        return g, None, None, None


def gather_block(t: torch.Tensor, plan: Plan, mesh, *,
                 offset: int = 0) -> torch.Tensor:
    """This rank's block ``t`` of a parameter, gathered along every
    dimension of ``plan`` (FSDP); ``offset``: leading dimensions of the
    full tensor that ``t`` lacks (1 for one layer of a stacked tensor).
    Backward: the reduce-scatter as a mean over the gathered axes (with
    gradients off, as in prefill and decode, the gathers alone)."""
    for dim, axes in plan:
        t = _Gather.apply(t, dim - offset, [mesh.get_group(a) for a in axes],
                          True)
    return t


# -- the model axis -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The "model" axis of the current mesh: its group, size and this
    rank's coordinate."""

    group: Any
    n: int
    j: int

    def split(self, local: int, full: int) -> bool:
        """Whether a dimension of ``full`` elements held with ``local`` is
        this rank's 1/n block (at n = 1, the whole dimension)."""
        return local * self.n == full

    def block(self, full: int) -> tuple[int, int]:
        """[lo, hi) of this rank's block of a dimension of ``full``."""
        size = full // self.n
        return self.j * size, (self.j + 1) * size


# no tensor parallelism: one rank holding every column, each collective
# of a region skipped
UNIT = ModelAxis(None, 1, 0)


def model_axis() -> ModelAxis | None:
    """The mesh's "model" axis when the current rules have tensor
    parallelism ("heads" over "model": the training rules but
    ``tp=False``'s, and the serving rules), else None."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None \
            or rules.mesh_axes("heads") != "model":
        return None
    shape = mesh_shape(mesh)
    if "model" not in shape:
        return None
    return ModelAxis(mesh.get_group("model"), shape["model"],
                     mesh_coords(mesh)["model"])


def tp_axis(local: int, full: int) -> ModelAxis:
    """The axis a module's forward runs its region over: the mesh's
    "model" axis where a weight dimension of ``full`` elements, held with
    ``local``, is this rank's block of it, else :data:`UNIT` (the plain
    computation on whole weights)."""
    ax = model_axis()
    return ax if ax is not None and ax.split(local, full) else UNIT


def cache_seq_block(local: int, full: int | None) -> tuple[int, int]:
    """[lo, hi) of the positions this rank holds of a cache's "cache_seq"
    dimension of ``full`` positions, held with ``local``: its block over
    "model" where the rules split it there (``serve_rules(kv_shard=
    "seq")`` on a model axis of size > 1 that divides ``full``), else
    every position.  ``full`` may be None only where the dimension is not
    split: a block alone does not tell a split dimension from one that the
    divisibility fallback left whole."""
    rules, ax = current_rules(), model_axis()
    if ax is None or ax.n == 1 or rules.mesh_axes("cache_seq") != "model":
        return 0, local
    if full is None:
        raise ValueError(
            "a cache split over 'model' along its positions: give the "
            "prefill and decode factories the cache's length (cache_len, "
            "enc_len)")
    if local == full and full % ax.n:  # the divisibility fallback
        return 0, full
    if local * ax.n != full:
        raise ValueError(f"a cache block of {local} positions is not this "
                         f"rank's block of {full} on model={ax.n}")
    return ax.block(full)


def enter(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """``x`` (replicated over "model") as it enters a region: the identity;
    backward, the sum of the ranks' partial cotangents."""
    return replicated(x, [ax.group]) if ax.n > 1 else x


def leave(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """A region's partial result summed over "model"; backward, the
    identity (the cotangent is replicated)."""
    return psum(x, [ax.group]) if ax.n > 1 else x


def psum_region(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """A sum over "model" that the region's ranks read: summed both ways."""
    return enter(leave(x, ax), ax)


def gather(x: torch.Tensor, dim: int, ax: ModelAxis) -> torch.Tensor:
    """This rank's block of an activation inside a region, gathered over
    "model" along ``dim``; backward, the reduce-scatter of the ranks'
    parts."""
    return _Gather.apply(x, dim, [ax.group], False) if ax.n > 1 else x


def all_reduce_max(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """The elementwise maximum over "model" (a value: no gradient)."""
    out = x.detach().clone()
    if ax.n > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ax.group)
    return out
