"""Logical-axis sharding rules (DP / TP / EP / SP / FSDP) over a mesh of
one process per card.

The counterpart of ``repro.runtime.sharding``.  Every tensor is annotated
with *logical* axis names ("batch", "heads", "ff", "experts", ...); a
:class:`ShardingRules` table maps logical names to mesh axes, and
:func:`logical_to_spec` turns a tensor's axes into a
:class:`PartitionSpec` with the reference's divisibility fallback (a rule
is applied per tensor only when the dimension divides by the mesh axes'
size; otherwise the axis is dropped and the event recorded in
:func:`sharding_report`).  The tables, the specs and the fallback messages
are the reference's, so both packages can be held against each other on
meshes of any shape: :func:`logical_to_spec` reads only the size of each
mesh axis, from the port's ``DeviceMesh`` or from any object with a
``shape`` mapping of axis -> size.

The partitioning is explicit: XLA partitions the reference's program by
itself, while here each rank holds its own block of every tensor and runs
the model code on it, with ``torch.distributed`` collectives where GSPMD
inserts them (:mod:`~repro_torch.runtime.partition`).
:class:`NamedSharding` gives a rank its block (``local_slice``) and the
block's shape (``shard_shape``).  :func:`explicit_spec` is
:func:`logical_to_spec` under every table: the trainer holds the
reference's block of every parameter, optimizer moment and batch (data
and tensor parallelism, FSDP, the experts), and prefill and decode the
reference's block of every served weight, cache entry, prompt and
logit (tensor parallelism over "model", the KV cache over its kv heads
or its positions, the ``/wsharded`` weights' FSDP), and the training step
splits the residual stream along its positions where the rules map the
activations' "seq" (sequence and token parallelism,
:func:`~repro_torch.runtime.partition.stream_axis`).  :func:`shard` keeps the
reference's contract (a no-op without a mesh, a rank check, the fallback
record) and returns the local tensor unchanged: the reference's ``shard``
calls are GSPMD layout hints, with no counterpart when each rank already
holds its block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping, Sequence

__all__ = [
    "LOGICAL_AXES", "ShardingRules", "PartitionSpec", "NamedSharding",
    "use_rules", "current_rules", "current_mesh", "shard", "logical_to_spec",
    "explicit_spec", "train_rules", "serve_rules", "sharding_report",
    "named_sharding", "mesh_shape", "mesh_coords", "batch_axes",
    "fresh_report", "is_train_rules", "note", "spec_axes", "token_axes",
]

# The logical axis vocabulary used across the model zoo.
LOGICAL_AXES = (
    "batch",        # global batch                         -> DP ("pod","data")
    "seq",          # sequence (activations)               -> SP (optional)
    "d_model",      # residual stream
    "heads",        # attention query heads                -> TP
    "kv_heads",     # attention kv heads                   -> TP
    "head_dim",
    "qkv",          # fused q/k/v projection output        -> TP
    "ff",           # feed-forward hidden                  -> TP
    "vocab",        # embedding/vocab                      -> TP
    "experts",      # MoE experts                          -> EP
    "expert_cap",   # per-expert capacity buffer
    "kv_lora",      # MLA latent
    "state",        # SSM / RG-LRU recurrent state width   -> TP
    "cache_seq",    # KV-cache sequence dim (decode)       -> seq-sharded KV
    "layers",       # stacked scan axis (never sharded)
    "conv",         # conv kernel taps
    "fsdp",         # the non-TP dim of a weight; shards over data in train
)


class PartitionSpec(tuple):
    """Mesh axes per tensor dimension: ``None`` (replicated), one axis name
    or a tuple of them; trailing ``None`` dimensions are left out.  A tuple,
    so it compares equal to the reference's ``PartitionSpec`` as one."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis -> mesh axis (or tuple of mesh axes, or None)."""

    rules: Mapping[str, tuple[str, ...] | str | None]
    name: str = "custom"

    def mesh_axes(self, logical: str | None):
        if logical is None:
            return None
        if logical not in self.rules:
            return None
        return self.rules[logical]


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size: of a ``DeviceMesh`` (its dimension names and
    shape), or of any object with a ``shape`` mapping (a JAX mesh, or a
    stand-in that has no devices)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(mesh.shape)


def mesh_coords(mesh) -> dict[str, int]:
    """This rank's coordinate on each axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


_tls = threading.local()


def current_rules() -> ShardingRules | None:
    return getattr(_tls, "rules", None)


def current_mesh():
    return getattr(_tls, "mesh", None)


_REPORT: dict[str, list[str]] = {}


def sharding_report() -> dict[str, list[str]]:
    """Divisibility fallbacks and the gathers of :func:`note`, recorded
    since process start (context -> messages)."""
    return _REPORT


def _record_fallback(context: str, msg: str) -> None:
    _REPORT.setdefault(context, [])
    if msg not in _REPORT[context]:
        _REPORT[context].append(msg)


def note(context: str, msg: str) -> None:
    """Record ``msg`` under ``context`` in :func:`sharding_report`, once:
    where the explicit partitioning gathers over a mesh axis what the
    reference's layout keeps sharded."""
    _record_fallback(context, msg)


@contextlib.contextmanager
def fresh_report():
    """Record into an empty report inside (yielded: what this block
    recorded, each message once), then add it to the process's."""
    global _REPORT
    outer, _REPORT = _REPORT, {}
    try:
        yield _REPORT
    finally:
        inner, _REPORT = _REPORT, outer
        for context, msgs in inner.items():
            for msg in msgs:
                _record_fallback(context, msg)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None, mesh=None):
    """Activate rules (+ mesh) for model code run inside the context (in
    this thread)."""
    prev_r = getattr(_tls, "rules", None)
    prev_m = getattr(_tls, "mesh", None)
    _tls.rules, _tls.mesh = rules, mesh
    try:
        yield
    finally:
        _tls.rules, _tls.mesh = prev_r, prev_m


def _as_tuple(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _as_tuple(axes))


def logical_to_spec(axes: Sequence[str | None],
                    shape: Sequence[int] | None = None,
                    rules: ShardingRules | None = None,
                    mesh=None, context: str = "") -> PartitionSpec:
    """Build a PartitionSpec from logical axes, with divisibility fallback."""
    rules = rules if rules is not None else current_rules()
    mesh = mesh if mesh is not None else current_mesh()
    if rules is None:
        return P()
    used: set[str] = set()
    out = []
    for i, name in enumerate(axes):
        m = rules.mesh_axes(name)
        if m is None:
            out.append(None)
            continue
        # one mesh axis may appear only once in a spec
        m_t = tuple(a for a in _as_tuple(m) if a not in used)
        if not m_t:
            out.append(None)
            continue
        if shape is not None and mesh is not None:
            size = _axis_size(mesh, m_t)
            if shape[i] % size != 0:
                _record_fallback(
                    context or rules.name,
                    f"axis {name!r} dim {shape[i]} not divisible by {m_t}="
                    f"{size}; replicated")
                out.append(None)
                continue
        used.update(m_t)
        out.append(m_t[0] if len(m_t) == 1 else m_t)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def is_train_rules(rules: ShardingRules | None) -> bool:
    """Whether ``rules`` are a :func:`train_rules` table (by its name)."""
    return rules is not None and rules.name.split("/")[0] == "train"


def spec_axes(spec: PartitionSpec) -> tuple[str, ...]:
    """The mesh axes a spec shards over, in its order."""
    return tuple(a for part in spec for a in _as_tuple(part))


def explicit_spec(axes: Sequence[str | None], shape: Sequence[int],
                  rules: ShardingRules | None = None, mesh=None,
                  context: str = "") -> PartitionSpec:
    """The spec each rank's block follows: :func:`logical_to_spec`'s, every
    mapping applied (the training activations' "seq" too: the step splits
    the residual stream along its positions)."""
    return logical_to_spec(axes, shape, rules, mesh, context)


def batch_axes(mesh, rules: ShardingRules | None = None) -> tuple[str, ...]:
    """The mesh axes the global batch shards over: the rules' "batch"
    mapping (the reference's ``("pod", "data")`` without rules), in the
    mesh's order, those the mesh has."""
    rules = rules if rules is not None else current_rules()
    want = (_as_tuple(rules.mesh_axes("batch")) if rules is not None
            else ("pod", "data"))
    return tuple(a for a in mesh_shape(mesh) if a in want)


def token_axes(mesh, rules: ShardingRules | None = None) -> tuple[str, ...]:
    """The mesh axes a training step's tokens are split over, over which
    the trainer averages each gradient: the batch axes, and the axis the
    rules map the activations' "seq" onto where it is not tensor
    parallelism's (multi-pod ``tp=False``: token parallelism, a rank's
    gradient its tokens' part), in the mesh's order."""
    rules = rules if rules is not None else current_rules()
    want = set(batch_axes(mesh, rules))
    if is_train_rules(rules):
        tp = set(_as_tuple(rules.mesh_axes("heads")))
        want |= set(_as_tuple(rules.mesh_axes("seq"))) - tp
    return tuple(a for a in mesh_shape(mesh) if a in want)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: which block of a tensor each rank holds."""

    mesh: Any
    spec: PartitionSpec

    def _parts(self, ndim: int):
        parts = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        if len(parts) != ndim:
            raise ValueError(f"spec {self.spec} for a rank-{ndim} tensor")
        return parts

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of one rank's block of a tensor of ``shape``."""
        out = []
        for n, part in zip(shape, self._parts(len(shape))):
            size = _axis_size(self.mesh, part)
            if n % size:
                raise ValueError(f"dim {n} not divisible by {part}={size}")
            out.append(n // size)
        return tuple(out)

    def local_slice(self, tensor, coords: Mapping[str, int] | None = None):
        """Rank ``coords``' block of ``tensor`` (a view; by default this
        rank's, on a ``DeviceMesh``).  A dimension sharded over several mesh
        axes takes its block row-major over them, in the spec's order."""
        coords = mesh_coords(self.mesh) if coords is None else coords
        sizes = mesh_shape(self.mesh)
        index = []
        for n, part in zip(tensor.shape, self._parts(tensor.ndim)):
            block, at = n // _axis_size(self.mesh, part), 0
            for a in _as_tuple(part):
                at = at * sizes[a] + coords[a]
            index.append(slice(at * block, (at + 1) * block))
        return tensor[tuple(index)]


def named_sharding(axes: Sequence[str | None],
                   shape: Sequence[int] | None = None,
                   rules: ShardingRules | None = None, mesh=None,
                   context: str = "") -> NamedSharding | None:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    spec = logical_to_spec(axes, shape, rules, mesh, context)
    return NamedSharding(mesh, spec)


def shard(x, axes: Sequence[str | None], context: str = ""):
    """The reference's ``shard``: no-op without rules or a mesh; a rank
    mismatch raises; a divisibility fallback is recorded.  Each rank
    already holds its block, so ``x`` is returned unchanged."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(
            f"{len(axes)} logical axes for rank-{x.ndim} tensor ({context})")
    logical_to_spec(axes, x.shape, rules, mesh, context)
    return x


# ---------------------------------------------------------------------------
# Canonical rule tables (the reference's).
#
# Mesh axes: ("data", "model") single pod, ("pod", "data", "model") multi-pod.
# "pod" extends the DP group hierarchically (gradient reduction crosses pods
# once per step; everything else stays inside a pod).
# ---------------------------------------------------------------------------

def train_rules(multi_pod: bool = False, *, fsdp: bool = True,
                seq_shard: bool = False, tp: bool = True) -> ShardingRules:
    """DP over (pod, data); TP/EP over model; FSDP shards params over data.

    ``seq_shard`` additionally maps activation "seq" onto the model axis;
    ``tp=False`` turns off tensor parallelism: the batch shards over both
    axes and weights are fully FSDP-sharded across them (multi-pod: the
    batch over (pod, data) and the sequence over the model axis).
    """
    dp = ("pod", "data") if multi_pod else ("data",)
    if not tp:
        all_axes = dp + ("model",)
        batch_axes_ = dp if multi_pod else all_axes
        r: dict[str, tuple[str, ...] | str | None] = {
            "batch": batch_axes_,
            "seq": "model" if multi_pod else None,
            "d_model": None, "heads": None, "kv_heads": None,
            "head_dim": None, "qkv": None, "ff": None, "vocab": None,
            "experts": None, "expert_cap": None, "kv_lora": None,
            "state": None, "cache_seq": None, "layers": None, "conv": None,
            "fsdp": all_axes if fsdp else None,
        }
        return ShardingRules(r, name="train/no-tp")
    r = {
        "batch": dp,
        "seq": "model" if seq_shard else None,
        "d_model": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "qkv": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "expert_cap": None,
        "kv_lora": None,
        "state": "model",
        "cache_seq": None,
        "layers": None,
        "conv": None,
        # FSDP: the non-TP dimension of 2D weights shards over data.
        "fsdp": ("data",) if fsdp else None,
    }
    return ShardingRules(r, name="train")


def serve_rules(multi_pod: bool = False, *,
                kv_shard: str = "heads") -> ShardingRules:
    """Inference rules: no FSDP (weights TP only), KV cache layout
    selectable: ``kv_shard`` "heads" shards the cache's kv-head axis over
    model, "seq" the cache sequence axis instead."""
    dp = ("pod", "data") if multi_pod else ("data",)
    r: dict[str, tuple[str, ...] | str | None] = {
        "batch": dp,
        "seq": None,
        "d_model": None,
        "heads": "model",
        "kv_heads": "model" if kv_shard == "heads" else None,
        "head_dim": None,
        "qkv": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "expert_cap": None,
        "kv_lora": None,
        "state": "model",
        "cache_seq": "model" if kv_shard == "seq" else None,
        "layers": None,
        "conv": None,
        "fsdp": None,
    }
    return ShardingRules(r, name=f"serve/{kv_shard}")
