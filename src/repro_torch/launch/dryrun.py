"""Multi-card dry-run of the port: every (arch x shape x mesh) cell traced.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell's step on 512 fake host devices and reads the compiled,
partitioned program.  Here one process stands for one rank of the 256- or
512-card mesh over a ``fake`` process group (its collectives send
nothing; :func:`fake_world`), builds the program the port runs on that
card -- its block of every tensor (``explicit_spec``) under the cell's
rules -- from ``meta`` tensors (shapes and dtypes, nothing allocated),
and runs it under an :class:`~repro_torch.perf.OpCounter`.  The traced
rank is the heaviest (:func:`traced_rank`, in the record's
``traced_coords``): rank 0 but on a train cell, where the last block of
"model" (coordinate 0 on every other axis), whose positions attend the
most keys where the rules split the sequence over "model" (causal
attention).
Kernels follow the card's route: a meta tensor goes to the CUDA kernel's
wrapper, which counts the launch that a CUDA tensor of that dtype would
make (``kernels.ops``).  No GPU is needed, as the reference needs no TPU.

The program of a cell:
  * train: per microbatch the loss and gradients as
    ``Trainer.loss_and_grads`` computes them (under a mesh on its blocks:
    FSDP gathers, tensor parallelism, each gradient's mean over the batch
    axes), then the trainer's fused update
    (``Trainer.update``: global norm and AdamW); for the offload archs the
    step returns the bf16 gradients that the out-of-core optimizer takes,
    as the reference's does.  The step counter the update reads on the
    host stays on the host (a meta tensor has no value to read).
  * prefill: ``make_prefill_fn`` on the weights cast as ``Engine`` casts
    them (bf16 matrices), token ids as the engine holds them (int32);
    the offload archs under the reference's fully-sharded rules
    (:func:`serving_rules`).
  * decode: ``make_decode_fn`` at the cache's last position, held on the
    host as an int32 scalar (the reference's ``pos`` argument).

Layers and microbatches are loops of one program each: every layer loop
is traced at two and three repeats (fewer where it has fewer), the
microbatches at one and two, and the counts extrapolated
(:func:`~repro_torch.perf.extrapolate`, each segment's memory peak apart;
``scaled=False`` traces the whole program, which the tests hold it to).

The record keeps the reference's keys.  ``state_bytes_per_device`` is the
reference's analytic number (``logical_to_spec`` with the rules as
written, then ``NamedSharding.shard_shape``);
``explicit_state_bytes_per_device`` the bytes of the blocks the port's
program holds (``explicit_spec``).  On a train cell those are the
reference's blocks of every parameter, moment and batch (the trainer's
tensor parallelism and FSDP, ``TRAIN_NO_TP`` cells under ``tp=False``),
so the two are equal.  On a serve cell they are the reference's blocks
of every cast weight, cache entry and token batch under
:func:`serving_rules` (tensor parallelism over "model", the KV cache
over its kv heads or its positions as ``KV_SHARD`` says, the
``/wsharded`` weights over "data"), so the two are equal there too.
``trace_s`` stands where the reference has ``lower_s`` and
``compile_s``; ``cost_analysis`` and ``hlo_bytes`` have no counterpart
(there is no compiler and no HLO).

Usage (``REPRO_DRYRUN_DEVICES`` sets the fake world's size,
``REPRO_MESH_OVERRIDE`` the mesh's shape; nothing sets ``XLA_FLAGS``):
  python -m repro_torch.launch.dryrun --all --both-meshes
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape decode_32k
  ... knobs: --remat, --microbatches, --kv-shard, --seq-shard, --no-tp,
      --tag, --skip-existing
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable

import torch

from ..configs import (ARCHS, OFFLOAD_ARCHS, SHAPES, Shape, batch_specs,
                       cache_len_for, decode_specs, get_config,
                       shape_applicable)
from ..models import (cast_params, init_cache_specs, make_decode_fn,
                      make_prefill_fn, param_specs)
from ..models.config import ModelConfig
from torch.utils._pytree import tree_leaves

from ..perf import CostReport, OpCounter, extrapolate, storage_bytes
from ..runtime.sharding import (NamedSharding, ShardingRules, explicit_spec,
                                fresh_report, logical_to_spec, mesh_coords,
                                mesh_shape, serve_rules, train_rules,
                                use_rules)
from ..train import AdamWConfig, TrainConfig, Trainer, init_opt_state
from .mesh import make_production_mesh, production_mesh_shape

__all__ = ["KV_SHARD", "TRAIN_MICROBATCHES", "TRAIN_NO_TP", "Cell",
           "SkipCell", "build_cell", "depth_loops", "at_depth", "fake_world",
           "held_state_bytes", "main", "run_cell", "serving_rules",
           "trace_program", "traced_rank", "world_size"]

# per-arch gradient-accumulation microbatches for train_4k (the reference's)
TRAIN_MICROBATCHES = {
    "deepseek-v2-236b": 8,
    "llama4-maverick-400b-a17b": 8,
    "qwen2-72b": 4,
    "internlm2-20b": 2,
    "gemma-7b": 2,
    "llava-next-mistral-7b": 2,
    "mamba2-2.7b": 2,
    "recurrentgemma-2b": 2,
    "internlm2-1.8b": 1,
    "whisper-base": 1,
}

# small-activation archs the reference trains with pure FSDP (no TP): the
# batch over ("data", "model") on one pod, FSDP over every axis
TRAIN_NO_TP = ("internlm2-1.8b", "whisper-base")

# decode KV-cache layout per arch: "heads" shards kv heads over model,
# "seq" the cache sequence axis (the reference's table)
KV_SHARD = {
    "gemma-7b": "heads",
    "deepseek-v2-236b": "seq",
    "qwen2-72b": "seq",
    "internlm2-20b": "seq",
    "internlm2-1.8b": "seq",
    "llava-next-mistral-7b": "seq",
    "llama4-maverick-400b-a17b": "seq",
    "whisper-base": "seq",
    "recurrentgemma-2b": "seq",
    "mamba2-2.7b": "seq",
}


class SkipCell(Exception):
    pass


def serving_rules(arch: str, multi_pod: bool,
                  kv_shard: str | None = None) -> ShardingRules:
    """The reference's rules for an arch's prefill and decode cells:
    ``serve_rules`` with the arch's ``KV_SHARD`` layout, and for the
    offload archs "fsdp" over "data" too (their weights fully sharded,
    gathered a layer at a time: the ``/wsharded`` rules)."""
    rules = serve_rules(multi_pod, kv_shard=kv_shard or KV_SHARD.get(
        arch, "seq"))
    if arch not in OFFLOAD_ARCHS:
        return rules
    r = dict(rules.rules)
    r["fsdp"] = ("data",)
    return ShardingRules(r, name=rules.name + "/wsharded")


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A ``fake`` default process group of ``size`` ranks with this process
    as ``rank``, the stand-in for a mesh of cards; destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def world_size(multi_pod: bool) -> int:
    """The fake world's size: ``REPRO_DRYRUN_DEVICES``, or the mesh's."""
    n = os.environ.get("REPRO_DRYRUN_DEVICES")
    return int(n) if n else math.prod(production_mesh_shape(multi_pod)[0])


def traced_rank(shape_name: str, multi_pod: bool) -> int:
    """The rank a cell traces: on a train cell the last block of "model"
    (the mesh's last axis, row-major: coordinate 0 on the others), the
    heaviest where the sequence is split over "model" (its positions
    attend every key); rank 0 on a serve cell (it attends the decode
    tail)."""
    if SHAPES[shape_name].kind != "train":
        return 0
    return production_mesh_shape(multi_pod)[0][-1] - 1


# -- the loops of a program ---------------------------------------------------

def depth_loops(cfg: ModelConfig) -> dict[str, int]:
    """The stacked-layer loops of ``cfg`` and their repeats: the decoder's
    (the hybrid pattern's repetitions; a MoE config's leading dense layers
    and its MoE layers, each a group) and an encoder's."""
    if cfg.pattern:
        loops = {"layers": cfg.n_layers // len(cfg.pattern)}
    elif cfg.n_experts and cfg.first_k_dense:
        loops = {"dense": cfg.first_k_dense,
                 "moe": cfg.n_layers - cfg.first_k_dense}
    else:
        loops = {"layers": cfg.n_layers}
    if cfg.is_encdec:
        loops["encoder"] = cfg.enc_layers
    return loops


def at_depth(cfg: ModelConfig, loops: dict[str, int]) -> ModelConfig:
    """``cfg`` with each loop of :func:`depth_loops` at ``loops``' repeats
    (a hybrid pattern keeps its tail group)."""
    kw: dict[str, int] = {}
    if cfg.pattern:
        kw["n_layers"] = (loops["layers"] * len(cfg.pattern)
                          + cfg.n_layers % len(cfg.pattern))
    elif "moe" in loops:
        kw.update(first_k_dense=loops["dense"],
                  n_layers=loops["dense"] + loops["moe"])
    else:
        kw["n_layers"] = loops["layers"]
    if "encoder" in loops:
        kw["enc_layers"] = loops["encoder"]
    return dataclasses.replace(cfg, **kw)


# -- the programs -------------------------------------------------------------

def _alloc(shape, dtype, device) -> torch.Tensor:
    """A program's input: empty on meta; on a real device (the tests'
    check that meta counts equal real ones) small floats from a fixed seed
    and integer zeros (valid token ids)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if device == "meta":
        return torch.empty(tuple(shape), dtype=dt, device="meta")
    if not dt.is_floating_point:
        return torch.zeros(tuple(shape), dtype=dt, device=device)
    gen = torch.Generator(device=device).manual_seed(math.prod(shape) % 997)
    return (torch.randn(tuple(shape), generator=gen, device=device)
            * 0.02).to(dt)


def _block(axes, shape, rules, mesh, context: str) -> tuple[int, ...]:
    """This rank's block of a tensor: ``explicit_spec``'s."""
    if mesh is None:
        return tuple(shape)
    return NamedSharding(mesh, explicit_spec(
        axes, shape, rules, mesh, context=context)).shard_shape(shape)


def _train_program(cfg, shape: Shape, mesh, rules, *, microbatches: int,
                   offload: bool, opt_cfg: AdamWConfig, device="meta"):
    """``build(cfg, m)`` for a train cell: the arguments (parameters, the
    optimizer state, ``m`` microbatches of the cell's rows) and the step."""
    mode = "offload" if offload else "fused"

    def build(cfg, m):
        trainer = Trainer(cfg, opt_cfg, TrainConfig(
            microbatches=microbatches, mode=mode), device=device, mesh=mesh,
            rules=rules)
        params = {k: _alloc(trainer.shardings[k].shard_shape(s.shape)
                            if mesh is not None else s.shape, s.dtype, device)
                  for k, s in trainer.specs.items()}
        rows = shape.batch // microbatches
        batch = {k: _alloc(_block((None,) + s.axes, (m, rows) + s.shape[1:],
                                  rules, mesh, f"batch/{k}"), s.dtype, device)
                 for k, s in batch_specs(cfg, shape).items()}
        opt = None
        if not offload:
            opt = init_opt_state(params)
            opt["step"] = torch.zeros((), dtype=torch.int32)  # on the host

        def step():
            loss, grads = trainer.loss_and_grads(params, batch)
            if offload:
                return loss, {k: g.to(torch.bfloat16)
                              for k, g in grads.items()}
            return (loss, *trainer.update(params, opt, grads)[:2])
        return (params, opt, batch), step

    return build


def _serve_program(shape: Shape, mesh, rules, *, cache_len: int,
                   enc_len: int, device="meta"):
    """``build(cfg, None)`` for a prefill or decode cell: parameters cast as
    ``Engine`` casts them, the cache, the engine's int32 token ids (and
    decode's position)."""

    def build(cfg, _):
        specs = param_specs(cfg)
        params = cast_params(cfg, {
            k: _alloc(_block(s.axes, s.shape, rules, mesh, f"param/{k}"),
                      s.dtype, device) for k, s in specs.items()})
        cache = {k: _alloc(_block(s.axes, s.shape, rules, mesh,
                                  f"cache/{k}"), s.dtype, device)
                 for k, s in init_cache_specs(cfg, shape.batch, cache_len,
                                              enc_len).items()}
        if shape.kind == "prefill":
            batch = {k: _alloc(_block(s.axes, s.shape, rules, mesh,
                                      f"batch/{k}"), s.dtype, device)
                     for k, s in batch_specs(cfg, shape).items()}
            prefill = make_prefill_fn(cfg, cache_len=cache_len,
                                      enc_len=enc_len)

            def step():
                with use_rules(rules, mesh):
                    return prefill(params, batch, cache)
            return (params, batch, cache), step
        tok = decode_specs(cfg, shape)["tokens"]
        tokens = _alloc(_block(tok.axes, tok.shape, rules, mesh,
                               "decode/tokens"), tok.dtype, device)
        pos = torch.tensor(cache_len - 1, dtype=torch.int32)  # on the host
        decode = make_decode_fn(cfg, cache_len=cache_len, enc_len=enc_len)

        def step():
            with use_rules(rules, mesh):
                return decode(params, cache, tokens, int(pos))
        return (params, cache, tokens, pos), step

    return build


def held_state_bytes(cfg, shape: Shape, **program) -> int:
    """The bytes of the arguments the cell's program holds on a device --
    what ``run_cell`` records as ``explicit_state_bytes_per_device`` --
    without tracing its step (``program`` as :func:`trace_program` takes
    it)."""
    build, micro = _make_program(cfg, shape, **program)
    return storage_bytes(tree_leaves(build(cfg, micro)[0]))


def _count(build: Callable, cfg, m) -> CostReport:
    args, step = build(cfg, m)
    counter = OpCounter()
    counter.arguments(args)
    with counter:
        out = step()
    counter.outputs(out)
    return counter.report


def _make_program(cfg, shape: Shape, *, mesh=None, rules=None,
             microbatches: int = 1, offload: bool = False,
             cache_len: int | None = None, enc_len: int | None = None,
             opt_cfg: AdamWConfig = AdamWConfig(), device="meta"):
    """(build, microbatches or None) of the cell's program."""
    if shape.kind == "train":
        return _train_program(cfg, shape, mesh, rules,
                              microbatches=microbatches, offload=offload,
                              opt_cfg=opt_cfg, device=device), microbatches
    dflt = cache_len_for(cfg, shape)
    return _serve_program(
        shape, mesh, rules,
        cache_len=dflt[0] if cache_len is None else cache_len,
        enc_len=dflt[1] if enc_len is None else enc_len,
        device=device), None


def trace_program(cfg: ModelConfig, shape: Shape, *, scaled: bool = True,
                  **program) -> CostReport:
    """The per-device cost of the port's step for ``cfg`` at ``shape``.
    ``program``: ``mesh`` (None: one card, no rules) and ``rules``; a train
    step runs ``microbatches`` microbatches of ``shape.batch /
    microbatches`` rows (``offload``: it returns bf16 gradients instead of
    updating, ``opt_cfg``: AdamW's settings); serving takes a cache of
    ``cache_len`` positions (by default the reference's ``cache_len_for``)
    and ``enc_len`` encoder positions; ``device`` (meta unless a test
    asks for real tensors).  ``scaled``: two and three repeats of each
    layer loop and one and two microbatches, extrapolated (the memory peak
    by segments over the layers; over the microbatches it is two's);
    otherwise the whole program, traced."""
    build, micro = _make_program(cfg, shape, **program)
    if not scaled:
        return _count(build, cfg, micro)
    loops = depth_loops(cfg)
    # two repeats, where a loop has as many: its first and last iterations
    # are then apart, and each segment's peak is affine from there
    base = {k: min(n, 2) for k, n in loops.items()}

    def over_depth(m):
        at_base = _count(build, at_depth(cfg, base), m)
        return extrapolate(at_base, [
            (_count(build, at_depth(cfg, {**base, k: 3}), m), n, 2)
            for k, n in loops.items() if n > 2])

    if micro is None or micro == 1:
        return over_depth(micro)
    one, two = over_depth(1), over_depth(2)
    one.live = {}  # the memory reading is two's:
    out = extrapolate(one, [(two, micro, 1)])
    # a microbatch frees its temporaries before the next, so the peak above
    # the arguments is the same for two microbatches as for any more
    out.memory["temp_bytes"], out.live = two.memory["temp_bytes"], two.live
    return out


# -- cells ----------------------------------------------------------------------

def _itemsize(dtype) -> int:
    return getattr(torch, dtype).itemsize


def _analytic_state_bytes(entries, rules, mesh) -> int:
    """Per-device bytes of ``(axes, shape, dtype, context)`` inputs from
    their exact shard shapes under the rules as written (the reference's
    ``_analytic_state_bytes``)."""
    total = 0
    for axes, shape, dtype, context in entries:
        spec = logical_to_spec(axes, shape, rules, mesh, context)
        block = NamedSharding(mesh, spec).shard_shape(shape)
        total += math.prod(block) * _itemsize(dtype)
    return total


@dataclasses.dataclass
class Cell:
    """One (arch x shape x mesh) cell: its config, shape, mesh and rules,
    the reference's meta fields and analytic state bytes, and the
    program's knobs."""

    cfg: ModelConfig
    shape: Shape
    mesh: Any
    rules: ShardingRules
    meta: dict
    state_bytes: int
    program: dict

    def trace(self, scaled: bool = True) -> CostReport:
        return trace_program(self.cfg, self.shape, mesh=self.mesh,
                             rules=self.rules, scaled=scaled, **self.program)

    def held_bytes(self) -> int:
        """:func:`held_state_bytes` of the cell's program."""
        return held_state_bytes(self.cfg, self.shape, mesh=self.mesh,
                                rules=self.rules, **self.program)


def build_cell(arch: str, shape_name: str, *, multi_pod: bool,
               remat: str | None = None, microbatches: int | None = None,
               kv_shard: str | None = None, seq_shard: bool = False,
               tp: bool = True, opt_cfg: AdamWConfig = AdamWConfig(),
               mesh=None) -> Cell:
    """The cell's config, rules and mesh (by default the production mesh
    over the default process group), as the reference's ``build_cell``
    makes them, with its meta fields and analytic state bytes."""
    cfg = get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    offload = arch in OFFLOAD_ARCHS
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind,
            "multi_pod": multi_pod, "offload": offload, "remat": cfg.remat}

    if shape.kind == "train":
        if arch in TRAIN_NO_TP:
            tp = False
        rules = train_rules(multi_pod, seq_shard=seq_shard, tp=tp)
        meta["tp"] = tp
        mb = microbatches or TRAIN_MICROBATCHES.get(arch, 2)
        meta["microbatches"] = mb
        entries = [(s.axes, s.shape, s.dtype, f"param/{k}")
                   for k, s in param_specs(cfg).items()]
        for k, s in batch_specs(cfg, shape).items():
            entries.append(((None,) + s.axes,
                            (mb, s.shape[0] // mb) + s.shape[1:], s.dtype,
                            f"batch/{k}"))
        if not offload:
            for k, s in param_specs(cfg).items():
                entries += [(s.axes, s.shape, "float32", f"param/{k}")] * 2
            entries.append(((), (), "int32", "opt/step"))
        return Cell(cfg, shape, mesh, rules, meta,
                    _analytic_state_bytes(entries, rules, mesh),
                    dict(microbatches=mb, offload=offload, opt_cfg=opt_cfg))

    # inference: the reference serves bf16 weights; the offload archs with
    # fully-sharded weights (the data axis), gathered per layer
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    kv = kv_shard or KV_SHARD.get(arch, "seq")
    rules = serving_rules(arch, multi_pod, kv)
    if offload:
        meta["weights"] = "fully-sharded"
    meta["kv_shard"] = kv
    cache_len, enc_len = cache_len_for(cfg, shape)
    entries = [(s.axes, s.shape, s.dtype, f"param/{k}")
               for k, s in param_specs(bf16).items()]
    entries += [(s.axes, s.shape, s.dtype, f"cache/{k}")
                for k, s in init_cache_specs(bf16, shape.batch, cache_len,
                                             enc_len).items()]
    if shape.kind == "prefill":
        entries += [(s.axes, s.shape, s.dtype, f"batch/{k}")
                    for k, s in batch_specs(bf16, shape).items()]
    else:
        entries += [(s.axes, s.shape, s.dtype, f"decode/{k}")
                    for k, s in decode_specs(bf16, shape).items()]
    return Cell(cfg, shape, mesh, rules, meta,
                _analytic_state_bytes(entries, rules, mesh),
                dict(cache_len=cache_len, enc_len=enc_len))


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             tag: str = "", verbose: bool = True, scaled: bool = True,
             **knobs) -> dict:
    """Build, trace and record one cell under the default (fake) process
    group; writes ``<out_dir>/<mesh>/<arch>__<shape>[__tag].json``."""
    t0 = time.time()
    mesh_name = _mesh_name(multi_pod)
    cell_id = f"{arch}__{shape_name}" + (f"__{tag}" if tag else "")
    os.makedirs(f"{out_dir}/{mesh_name}", exist_ok=True)
    path = f"{out_dir}/{mesh_name}/{cell_id}.json"

    def write(rec):
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        return rec

    with fresh_report() as report:
        try:
            cell = build_cell(arch, shape_name, multi_pod=multi_pod, **knobs)
        except SkipCell as e:
            if verbose:
                print(f"[skip] {cell_id}: {e}", flush=True)
            return write({"arch": arch, "shape": shape_name,
                          "mesh": mesh_name, "status": "skip",
                          "reason": str(e)})
        n_devices = math.prod(mesh_shape(cell.mesh).values())
        rep = cell.trace(scaled=scaled)
    # the blocks the port's program holds: its arguments
    explicit = rep.memory["argument_bytes"]
    trace_s = time.time() - t0
    rec = {
        **cell.meta,
        "mesh": mesh_name,
        "status": "ok",
        "n_devices": n_devices,
        "traced_coords": mesh_coords(cell.mesh),
        "trace_s": round(trace_s, 2),
        "memory_analysis": {**rep.memory, "generated_code_bytes": None},
        "flops_per_device": rep.flops,
        "traffic_bytes_per_device": rep.bytes,
        "collective_bytes_per_device": rep.collective_bytes,
        "collectives": rep.collectives,
        "state_bytes_per_device": cell.state_bytes,
        "explicit_state_bytes_per_device": explicit,
        "flop_terms": rep.terms,
        "kernel_launches": {k: v["launches"] for k, v in rep.kernels.items()},
        "kernels": rep.kernels,
        "sharding_report": report,
    }
    if verbose:
        print(f"[ok] {cell_id} ({mesh_name}): trace {trace_s:.1f}s "
              f"flops/dev {rep.flops:.3e} coll/dev "
              f"{rep.collective_bytes / 2**20:.1f} MiB "
              f"state/dev {cell.state_bytes / 2**30:.2f} GiB "
              f"(held {explicit / 2**30:.2f} GiB)", flush=True)
    return write(rec)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--remat", choices=("full", "none", "dots"), default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--kv-shard", choices=("heads", "seq"), default=None)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--no-tp", action="store_true",
                    help="pure-FSDP training rules (no tensor parallelism)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else sorted(SHAPES)
    if not (args.all or (args.arch and args.shape)):
        ap.error("pass --all or both --arch and --shape")
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    knobs = dict(remat=args.remat, microbatches=args.microbatches,
                 kv_shard=args.kv_shard, seq_shard=args.seq_shard,
                 tp=not args.no_tp)
    failures = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                mesh_name = _mesh_name(mp)
                cell_id = f"{a}__{s}" + (f"__{args.tag}" if args.tag
                                         else "")
                path = f"{args.out}/{mesh_name}/{cell_id}.json"
                if args.skip_existing and os.path.exists(path):
                    print(f"[cached] {cell_id} ({mesh_name})", flush=True)
                    continue
                try:
                    with fake_world(world_size(mp), traced_rank(s, mp)):
                        run_cell(a, s, multi_pod=mp, out_dir=args.out,
                                 tag=args.tag, **knobs)
                except Exception:
                    failures.append((a, s, mp))
                    print(f"[FAIL] {a} {s} multi_pod={mp}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print("dry-run complete", flush=True)


if __name__ == "__main__":
    main()
