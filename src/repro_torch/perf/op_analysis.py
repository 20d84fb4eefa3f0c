"""Cost model of the port's programs, counted op by op.

The counterpart of ``repro.perf.hlo_analysis``.  The reference walks the
compiled, partitioned HLO of a step, because ``cost_analysis()`` counts
each while body once.  PyTorch has no HLO to walk: the port runs eagerly,
one aten op at a time, so the op stream a step dispatches *is* its
program.  :class:`OpCounter`, a ``TorchDispatchMode``, sees that stream
after autograd (the backward's ops too), on any device -- on ``meta``
tensors, where nothing is allocated, as well as on real ones, with the
same counts -- and builds the reference's :class:`CostReport`:

* flops -- ``mm``, ``addmm``, ``bmm`` and ``baddbmm`` count 2*M*N*K (the
  reference's ``dot``); a pointwise op (``torch.Tag.pointwise``, a dtype
  conversion) one per output element; a reduction max(input, output)
  elements; a hand-written kernel what its ``work`` function says
  (reported by the meta routes of :mod:`repro_torch.kernels.ops`).
  ``terms`` keeps the four apart ("products", "elementwise",
  "reductions", "kernels").
* bytes -- the program is unfused, so every op that is not a view reads
  its operands and writes its results.  Views and aliases count nothing,
  as the reference's transparent ops do; an in-place write into a slice
  (``copy_``, ``index_put_``) counts twice the slice, as a
  ``dynamic-update-slice`` does.
* collectives -- the ``c10d`` ops under the reference's five names, each
  counted once with its operand and result bytes.
* memory -- ``argument_bytes``, ``output_bytes`` and ``temp_bytes`` (the
  peak of live bytes beyond the arguments), the keys of the reference's
  ``memory_analysis``.  Live bytes are the storages the program holds: a
  weakref finalizer on each storage an op creates takes its bytes off
  when the storage dies, so the reading needs no device allocator and no
  ``nn.Module`` structure (``torch.distributed._tools.mem_tracker`` wants
  modules; the port's models are functions of flat dicts).

Trip counts: the reference scales while bodies by their trip counts.  The
port's stacked layers and microbatches are loops of one program each, and
the eager program is exactly affine in every such count, so
:func:`extrapolate` combines traces at two repeat counts into the cost at
any count (``repro_torch.launch.dryrun`` does it; the tests hold it to the
full trace).  The peak of live bytes is a maximum over the program's
ops of such affine terms, and which op wins can change with the depth (at
one layer a head's gradient, at eighty the layers' stacked gradients, or
AdamW's new tensors), so the counter keeps the live bytes after every op,
by *segment* (:attr:`CostReport.live`): every layer loop marks where its
first and last iterations begin and end, and a training loop does so in
the backward too (:func:`loop_mark`; a middle iteration's bytes lie
between theirs), so a segment runs the same ops at every depth.  Each op's live bytes are
extrapolated before the maximum is taken.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["CostReport", "OpCounter", "active_counter", "extrapolate",
           "loop_mark", "record_launch", "storage_bytes"]

_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "prod", "var",
    "std", "var_mean", "std_mean", "norm", "linalg_vector_norm", "cumsum",
    "cumprod", "argmax", "argmin", "any", "all", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "topk",
}

# ops that write their first argument without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_"}
# in-place updates of some rows: read and write only the update (the
# reference's dynamic-update-slice / scatter)
_UPDATES = {"index_put_", "index_add_", "index_copy_", "scatter_",
            "scatter_add_", "scatter_reduce_", "_index_put_impl_"}
# reads of some rows: read and write only the rows (the reference's gather)
_GATHERS = {"index_select", "gather", "embedding", "index"}
# allocations that write nothing
_FACTORIES = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}


@dataclasses.dataclass
class CostReport:
    """Per-device cost of a program: the reference's fields, with the
    FLOP terms, the kernels' launches and the memory reading beside them.
    Counts are integers, so sums and :func:`extrapolate` stay exact."""

    flops: int = 0
    bytes: int = 0
    collectives: dict = dataclasses.field(default_factory=dict)
    terms: dict = dataclasses.field(default_factory=lambda: {
        "products": 0, "elementwise": 0, "reductions": 0, "kernels": 0})
    kernels: dict = dataclasses.field(default_factory=dict)
    memory: dict = dataclasses.field(default_factory=lambda: {
        "argument_bytes": 0, "output_bytes": 0, "temp_bytes": 0})
    #: live bytes (arguments included) after each op, by segment of the
    #: program
    live: dict = dataclasses.field(default_factory=dict)

    def add(self, other: "CostReport", mult: int = 1) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.collectives.items():
            slot = self.collectives.setdefault(
                k, {"count": 0, "operand_bytes": 0, "result_bytes": 0})
            for f in slot:
                slot[f] += v[f] * mult
        for k, v in other.terms.items():
            self.terms[k] = self.terms.get(k, 0) + v * mult
        for k, v in other.kernels.items():
            slot = self.kernels.setdefault(
                k, {"launches": 0, "flops": 0, "bytes": 0})
            for f in slot:
                slot[f] += v[f] * mult
        for k, v in other.memory.items():
            self.memory[k] = self.memory.get(k, 0) + v * mult

    @property
    def collective_bytes(self) -> int:
        """Data-moved model: max(operand, result) per collective kind."""
        return sum(max(v["operand_bytes"], v["result_bytes"])
                   for v in self.collectives.values())

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": self.collectives,
                "collective_bytes": self.collective_bytes,
                "terms": self.terms, "kernels": self.kernels,
                "memory": self.memory}


def extrapolate(base: CostReport,
                steps: Iterable[tuple[CostReport, int, int]]) -> CostReport:
    """The cost at the real counts from a trace at a base count ``b`` of
    every loop (``base``) and, per loop, a trace with that loop at ``b + 1``
    and its real count ``n``: base + sum (n - b) * (step - base).  Exact for
    a cost affine in each count, which the port's loops are.  Each op's
    live bytes are extrapolated so too (in the segments of the base trace:
    a middle iteration has none there), and the peak above the arguments
    is their maximum less the arguments."""
    steps = list(steps)
    out = CostReport()
    out.add(base)
    for step, n, b in steps:
        out.add(step, n - b)
        out.add(base, -(n - b))
    for k, v in base.live.items():
        if any(len(step.live[k]) != len(v) for step, _, _ in steps):
            raise ValueError(f"segment {k} runs other ops at another depth")
        out.live[k] = [x + sum((n - b) * (step.live[k][i] - x)
                               for step, n, b in steps)
                       for i, x in enumerate(v)]
    if out.live:
        out.memory["temp_bytes"] = (
            max(max(v) for v in out.live.values())
            - out.memory["argument_bytes"])
    return out


def storage_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes of the distinct storages under ``tensors`` (a view counts its
    whole storage once): what a program holds for them on its device."""
    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads from ``t``: its elements, or its storage where
    that is smaller (a broadcast view reads its source once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _elems(ts) -> int:
    return sum(t.numel() for t in ts)


def _written_args(func) -> list[int]:
    """Positions of the arguments ``func`` writes."""
    return [i for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write]


_ACTIVE: list["OpCounter"] = []


def active_counter() -> "OpCounter | None":
    """The innermost :class:`OpCounter` that is counting, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


def _loop_label(kind: str, loop: str, i: int, n: int) -> str:
    where = "first" if i == 0 else "last" if i == n - 1 else "middle"
    return f"{kind}:{loop}:{where}"


def loop_mark(loop: str, i: int, n: int,
              x: torch.Tensor | None = None) -> None:
    """For the active counter, if any: iteration ``i`` of the ``n`` of a
    layer loop begins (``i == n``: the loop has ended), ``x`` entering it
    (leaving the loop; None where nothing is differentiated).  Forward, a
    segment begins here; backward, where ``x``'s gradient is ready (a hook
    that leaves it as it is), iteration ``i - 1``'s backward begins (``i ==
    0``: the loop's backward has ended).  Without a counter it does
    nothing."""
    counter = active_counter()
    if counter is None:
        return
    counter.mark(_loop_label("F", loop, i, n) if i < n else None)
    if x is not None and x.requires_grad:
        label = _loop_label("B", loop, i - 1, n) if i > 0 else None
        x.register_hook(lambda g: counter.mark(label))


def record_launch(name: str, flops: int, nbytes: int) -> None:
    """One launch of kernel ``name`` doing ``flops`` and moving ``nbytes``,
    for the active counter (a kernel's meta route reports here)."""
    counter = active_counter()
    if counter is not None:
        counter.launch(name, flops, nbytes)


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it into :attr:`report`.

    ``arguments(tree)``, before the program runs, enters the program's
    inputs into the memory reading; ``outputs(tree)``, after, its
    results.  ``report.memory`` is then final."""

    def __init__(self):
        super().__init__()
        self.report = CostReport()
        self._live = 0
        self._args: set = set()
        self._tracked: dict = {}
        # the segment being counted, its live bytes after each op, and how
        # often each label came
        self._segment, self._timeline = "S:0", [0]
        self._plain = 1
        self._seen: dict = {}

    # -- memory -------------------------------------------------------------
    def _track(self, t: torch.Tensor, *, argument: bool = False) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key in self._tracked:
            if argument and key not in self._args:
                self._args.add(key)
                self.report.memory["argument_bytes"] += st.nbytes()
            return
        n = st.nbytes()
        self._tracked[key] = n
        self._live += n
        if argument:
            self._args.add(key)
            self.report.memory["argument_bytes"] += n
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        n = self._tracked.pop(key, 0)
        self._live -= n
        self._args.discard(key)

    def mark(self, label: str | None) -> None:
        """End the current segment and begin one named ``label`` (each
        occurrence of a label is its own segment), or the next unnamed one
        (None)."""
        self.report.live[self._segment] = self._timeline
        if label is None:
            label, self._plain = f"S:{self._plain}", self._plain + 1
        else:
            k = self._seen.get(label, 0)
            self._seen[label] = k + 1
            label = f"{label}#{k}"
        self._segment, self._timeline = label, [self._live]

    def arguments(self, tree) -> None:
        for t in _tensors(tree):
            self._track(t, argument=True)

    def outputs(self, tree) -> None:
        keys = set()
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st._cdata not in self._args and st._cdata not in keys:
                keys.add(st._cdata)
                self.report.memory["output_bytes"] += st.nbytes()
        self.mark(None)
        self.report.memory["temp_bytes"] = (
            max(max(v) for v in self.report.live.values())
            - self.report.memory["argument_bytes"])

    # -- ops ----------------------------------------------------------------
    def launch(self, name: str, flops: int, nbytes: int) -> None:
        slot = self.report.kernels.setdefault(
            name, {"launches": 0, "flops": 0, "bytes": 0})
        slot["launches"] += 1
        slot["flops"] += flops
        slot["bytes"] += nbytes
        self._flops("kernels", flops)
        self.report.bytes += nbytes

    def _flops(self, term: str, n: int) -> None:
        self.report.terms[term] += n
        self.report.flops += n

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args, out)
        else:
            self._op(func, args, kwargs, out)
        self._timeline.append(self._live)
        return out

    def _collective(self, func, args, out) -> None:
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVES.get(name)
        if kind is None:
            return
        ins = _tensors(args)
        if name in ("_allgather_base_", "_reduce_scatter_base_",
                    "alltoall_base_"):
            results, operands = ins[:1], ins[1:2]  # (output, input, ...)
        elif name in ("allgather_", "reduce_scatter_", "alltoall_"):
            results, operands = _tensors(args[0]), _tensors(args[1])
        else:  # in place: the tensors are operand and result
            results = operands = _tensors(args[0])
        ob = sum(t.numel() * t.element_size() for t in operands)
        rb = sum(t.numel() * t.element_size() for t in results)
        slot = self.report.collectives.setdefault(
            kind, {"count": 0, "operand_bytes": 0, "result_bytes": 0})
        slot["count"] += 1
        slot["operand_bytes"] += ob
        slot["result_bytes"] += rb
        self.report.bytes += ob + rb

    def _op(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        written = _written_args(func)
        in_storages = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs
                 if t.untyped_storage()._cdata not in in_storages]
        if not written and outs and not fresh:
            return  # a view or an alias: no traffic, no new storage
        for t in fresh:
            self._track(t)
        if name in _FACTORIES:
            return
        # -- flops --------------------------------------------------------
        if name in ("mm", "addmm", "bmm", "baddbmm"):
            a, b = (args[0], args[1]) if name in ("mm", "bmm") else \
                (args[1], args[2])
            self._flops("products", 2 * a.numel() * b.shape[-1])
            if name in ("addmm", "baddbmm"):
                self._flops("elementwise", _elems(outs))
        elif torch.Tag.pointwise in func.tags:
            self._flops("elementwise", _elems(outs))
        elif name == "_to_copy" or name == "copy_":
            src = args[1] if name == "copy_" else args[0]
            dst = args[0] if name == "copy_" else outs[0]
            if src.dtype != dst.dtype:  # a conversion, as XLA's convert
                self._flops("elementwise", dst.numel())
        elif name in _REDUCTIONS:
            first = ins[0] if ins else None
            self._flops("reductions", max(
                first.numel() if first is not None else 0, _elems(outs)))
        # -- bytes --------------------------------------------------------
        if name in _GATHERS:  # read the rows taken, write them
            idx = [t for t in ins if not t.is_floating_point()]
            self.report.bytes += (2 * sum(t.numel() * t.element_size()
                                          for t in outs)
                                  + sum(_read_bytes(t) for t in idx))
            return
        if name in _UPDATES:
            upd = args[2] if name in ("index_put_", "_index_put_impl_",
                                      "index_add_", "index_copy_") else \
                args[3] if len(args) > 3 else kwargs.get("src")
            upd_b = _read_bytes(upd) if isinstance(upd, torch.Tensor) else 0
            idx = [t for t in ins if t is not upd and t is not args[0]]
            self.report.bytes += 2 * upd_b + sum(_read_bytes(t) for t in idx)
            return
        if written:
            targets = [args[i] for i in written if i < len(args)
                       and isinstance(args[i], torch.Tensor)]
            reads = [t for t in ins
                     if not any(t is w for w in targets)
                     or name not in _WRITE_ONLY]
            self.report.bytes += (sum(_read_bytes(t) for t in reads)
                                  + sum(t.numel() * t.element_size()
                                        for t in targets))
            return
        self.report.bytes += (sum(_read_bytes(t) for t in ins)
                              + sum(t.numel() * t.element_size()
                                    for t in outs))
