"""Tensor parallelism, FSDP and the sequence's split on a mesh: the
explicit counterparts of what GSPMD inserts into the reference's train,
prefill and decode steps.

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
  a whole weight used there goes through :func:`whole`, and a sum that
  the region's ranks read (:func:`psum_region`) sums both ways.  Where a
  block does not align with what the math needs (a kv head split across
  ranks, Mamba-2's fused projection), the module gathers the activation
  over "model" as GSPMD would, and records it once in
  ``sharding_report()``.  Each module has one forward: off the mesh, or
  where its weights are whole, it runs its region on :data:`UNIT`
  (:func:`tp_axis`), where every collective is skipped and the region is
  the plain computation.
* The sequence.  Where the training rules map the activations' "seq"
  onto a mesh axis (:func:`seq_axis`: ``train_rules(seq_shard=True)`` and
  multi-pod ``tp=False``), the residual stream is split along its
  positions (:func:`stream_axis`; a length that does not divide stays
  whole, recorded as the divisibility fallback): each rank holds and
  computes its block ``(lo, hi)``.  Sharing "model" with tensor
  parallelism it is Megatron's sequence parallelism: a region's
  :func:`enter` all-gathers the positions (backward, the reduce-scatter)
  and its :func:`leave` reduce-scatters the partial results (backward,
  the all-gather), and the parameters read on the split stream (the norms
  between the regions) sum their ranks' parts in the backward
  (:func:`seq_param`).  Without tensor parallelism it is token
  parallelism: attention gathers the keys and values over the positions
  (:func:`gather`), every other module runs on the rank's positions, and
  a rank's gradient is its tokens' part, which the trainer's mean over the
  token axes (:func:`~.sharding.token_axes`) sums.  A module that needs
  every position (the SSM and RG-LRU scans, the MoE dispatch; under
  sequence parallelism one whose weights are whole) runs on the whole
  sequence between :func:`seq_gather` and :func:`seq_scatter`.
* A decode cache split over "model" along its positions ("cache_seq"
  under ``serve_rules(kv_shard="seq")``): :func:`cache_seq_block` gives
  this rank's positions, and attention over them is a partial that
  :func:`~.collectives.flash_decode_psum` combines.

Gradients.  The loss's cross-entropy sum enters its all-reduce over the
axes its positions are split over with a gradient scale
(:func:`~.collectives.psum`): the data-parallel size, so that a rank's
gradient is its share of the global one times that size; under token
parallelism the number of ranks the tokens are split over, so that a
rank's gradient is its tokens' part times that number.  The trainer then
takes, per tensor, the mean over the token axes its block's gather did
not already reduce over (:func:`reduction_axes`): ``Σ over them / their
size`` after the gather's mean gives the global gradient, for every table
of ``train_rules``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from .collectives import _all_gather, _reduce_scatter, psum, replicated
from .sharding import (PartitionSpec, ShardingRules, current_mesh,
                       current_rules, explicit_spec, is_train_rules,
                       logical_to_spec, mesh_coords, mesh_shape, token_axes)

__all__ = ["TP_LOGICAL", "ModelAxis", "UNIT", "model_axis", "tp_axis",
           "tp_kept", "cache_seq_block", "seq_axis", "stream_axis",
           "sequence_parallel", "seq_param", "seq_gather", "seq_scatter",
           "gather_plan", "block_plans", "gather_block", "reduction_axes",
           "enter", "leave", "whole", "gather", "psum_region",
           "all_reduce_max"]

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
    """The token axes (:func:`~.sharding.token_axes`) a parameter's
    gradient is still averaged over after its gather's backward: those its
    plan does not gather over."""
    done = {a for _, axes in plan for a in axes}
    return tuple(a for a in token_axes(mesh, rules) if a not in done)


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


def _block_of(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over ``group``."""
    n = dist.get_world_size(group)
    size = t.shape[dim] // n
    return t.narrow(dim, dist.get_rank(group) * size, size)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``groups`` (a dimension sharded over
    several axes is laid out row-major over them, so the innermost is
    gathered first); backward by ``dual``: ``"sum"`` the reduce-scatter,
    ``"mean"`` the reduce-scatter divided by the groups' size, ``"block"``
    this rank's block of the cotangent (one that every rank holds
    whole)."""

    @staticmethod
    def forward(ctx, x, dim, groups, dual):
        ctx.dim, ctx.groups, ctx.dual = dim, groups, dual
        out = x
        for g in reversed(groups):
            out = _gather_dim(out, dim, g)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        if ctx.dual == "block":
            for grp in ctx.groups:
                g = _block_of(g, ctx.dim, grp)
            return g.contiguous(), None, None, None
        n = 1
        for grp in ctx.groups:
            g = _scatter_dim(g, ctx.dim, grp)
            n *= dist.get_world_size(grp)
        if ctx.dual == "mean" and n > 1:
            g = g / n
        return g, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """The ranks' partial results summed over ``group``, this rank's block
    along ``dim`` kept; backward, the all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.group), None, None


class _Scatter(torch.autograd.Function):
    """This rank's block along ``dim`` over ``group``; backward by
    ``dual``: ``"gather"`` the all-gather of the ranks' blocks (a
    cotangent every rank holds whole), ``"pad"`` the block in place with
    zeros elsewhere (each rank holds its part)."""

    @staticmethod
    def forward(ctx, x, dim, group, dual):
        ctx.dim, ctx.group, ctx.dual, ctx.n = dim, group, dual, x.shape[dim]
        return _block_of(x, dim, group).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        if ctx.dual == "gather":
            return _gather_dim(g, ctx.dim, ctx.group), None, None, None
        shape = list(g.shape)
        shape[ctx.dim] = ctx.n
        out = g.new_zeros(shape)
        _block_of(out, ctx.dim, ctx.group).copy_(g)
        return out, None, None, None


def gather_block(t: torch.Tensor, plan: Plan, mesh, *,
                 offset: int = 0) -> torch.Tensor:
    """This rank's block ``t`` of a parameter, gathered along every
    dimension of ``plan`` (FSDP); ``offset``: leading dimensions of the
    full tensor that ``t`` lacks (1 for one layer of a stacked tensor).
    Backward: the reduce-scatter as a mean over the gathered axes (with
    gradients off, as in prefill and decode, the gathers alone)."""
    for dim, axes in plan:
        t = _Gather.apply(t, dim - offset, [mesh.get_group(a) for a in axes],
                          "mean")
    return t


# -- the model axis -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The "model" axis of the current mesh: its group, size and this
    rank's coordinate."""

    group: Any
    n: int
    j: int
    # the stream at a region's boundaries is split over this axis along its
    # positions (sequence parallelism: :func:`enter` and :func:`leave`
    # gather and reduce-scatter them)
    seq: bool = False

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


def tp_axis(local: int, full: int, sq: ModelAxis = UNIT) -> ModelAxis:
    """The axis a module's forward runs its region over: the mesh's
    "model" axis where a weight dimension of ``full`` elements, held with
    ``local``, is this rank's block of it, else :data:`UNIT` (the plain
    computation on whole weights).  ``sq``: the axis the module's input
    stream is split over along its positions (:func:`stream_axis`); a
    split one marks the region's boundaries as sequence-parallel."""
    ax = model_axis()
    if ax is None or not ax.split(local, full):
        return UNIT
    return dataclasses.replace(ax, seq=True) if sq.n > 1 else ax


def seq_axis() -> ModelAxis:
    """The mesh axis the current training rules map the activations'
    "seq" onto (``train_rules(seq_shard=True)``'s and multi-pod
    ``tp=False``'s "model"), with this rank's coordinate: its block of a
    sequence of ``full`` positions is ``block(full)``.  :data:`UNIT`
    under any other rules, off a mesh or on an axis of size 1."""
    rules, mesh = current_rules(), current_mesh()
    if mesh is None or not is_train_rules(rules):
        return UNIT
    shape = mesh_shape(mesh)
    part = rules.mesh_axes("seq")
    axes = [a for a in ((part,) if isinstance(part, str) else part or ())
            if a in shape]
    if len(axes) > 1:
        raise NotImplementedError(f"'seq' over {tuple(axes)}: one mesh axis")
    if not axes or shape[axes[0]] == 1:
        return UNIT
    return ModelAxis(mesh.get_group(axes[0]), shape[axes[0]],
                     mesh_coords(mesh)[axes[0]])


def stream_axis(full: int, context: str = "activations") -> ModelAxis:
    """The axis a residual stream of ``full`` positions is split over in
    the current step: :func:`seq_axis`, or :data:`UNIT` where the length
    does not divide by its size (``logical_to_spec``'s fallback, recorded
    in ``sharding_report()`` under ``context``)."""
    sq = seq_axis()
    if sq.n == 1:
        return UNIT
    spec = logical_to_spec((None, "seq"), (1, full), current_rules(),
                           current_mesh(), context)
    return sq if len(spec) == 2 else UNIT


def sequence_parallel(sq: ModelAxis) -> bool:
    """Whether a stream split over ``sq`` shares the axis with tensor
    parallelism (Megatron's sequence parallelism): a rank then holds the
    whole cotangent of what it holds whole, as in a tensor-parallel step.
    Without (token parallelism) it holds its part: the cotangent its own
    tokens give."""
    return sq.n > 1 and model_axis() is not None


def seq_param(t: torch.Tensor, sq: ModelAxis) -> torch.Tensor:
    """A parameter held whole that a module reads on the rank's positions
    of a stream split over ``sq``: under sequence parallelism (the norms
    between the regions) its backward sums the ranks' partial gradients
    over the axis; under token parallelism, and on :data:`UNIT`, the
    identity (each rank's gradient is its tokens' part)."""
    return replicated(t, [sq.group]) if sequence_parallel(sq) else t


def seq_gather(x: torch.Tensor, sq: ModelAxis) -> torch.Tensor:
    """The whole sequence (dimension 1) of a stream split over ``sq``, for
    a module that runs on every position on each rank: the all-gather;
    backward, under sequence parallelism this rank's block of the
    cotangent (the module's computation is replicated, and so is its
    cotangent), under token parallelism the reduce-scatter of the ranks'
    parts (:func:`seq_scatter` hands each rank its part)."""
    if sq.n == 1:
        return x
    return _Gather.apply(x, 1, [sq.group],
                         "block" if sequence_parallel(sq) else "sum")


def seq_scatter(x: torch.Tensor, sq: ModelAxis) -> torch.Tensor:
    """This rank's block of the positions of ``x`` (dimension 1), computed
    on the whole sequence (after :func:`seq_gather`); backward, under
    sequence parallelism the all-gather of the ranks' blocks, under token
    parallelism the block in place with zeros elsewhere."""
    if sq.n == 1:
        return x
    return _Scatter.apply(x, 1, sq.group,
                          "gather" if sequence_parallel(sq) else "pad")


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
    """The stream ``x`` as it enters a region: replicated over "model", the
    identity, backward the sum of the ranks' partial cotangents; split
    along its positions (``ax.seq``), the all-gather of the positions,
    backward the reduce-scatter of those sums."""
    if ax.n == 1:
        return x
    if ax.seq:
        return _Gather.apply(x, 1, [ax.group], "sum")
    return replicated(x, [ax.group])


def leave(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """A region's partial result summed over "model"; backward, the
    identity (the cotangent is replicated).  Where the stream is split
    along its positions (``ax.seq``), the sum's reduce-scatter to this
    rank's positions; backward, the all-gather."""
    if ax.n == 1:
        return x
    if ax.seq:
        return _ReduceScatter.apply(x, 1, ax.group)
    return psum(x, [ax.group])


def whole(t: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """A tensor held whole (replicated over "model": a whole weight, a
    bias, a parameter vector) that each rank of a region uses a part of:
    the identity; backward, the sum of the ranks' partial cotangents."""
    return replicated(t, [ax.group]) if ax.n > 1 else t


def psum_region(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """A sum over "model" that the region's ranks read: summed both ways."""
    return whole(psum(x, [ax.group]), ax) if ax.n > 1 else x


def gather(x: torch.Tensor, dim: int, ax: ModelAxis) -> torch.Tensor:
    """This rank's block of an activation, gathered over ``ax`` along
    ``dim`` (inside a region, or the keys and values of a stream split
    along its positions); backward, the reduce-scatter of the ranks'
    parts."""
    return _Gather.apply(x, dim, [ax.group], "sum") if ax.n > 1 else x


def all_reduce_max(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """The elementwise maximum over "model" (a value: no gradient)."""
    out = x.detach().clone()
    if ax.n > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ax.group)
    return out
