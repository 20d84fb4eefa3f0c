"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``.  Runs the real ``Trainer`` on
``--device`` (the card unless ``--device cpu``); ``--smoke`` runs the
reduced config, ``--layers N`` the config cut to N layers at its widths.

Rank-symmetric bootstrap
------------------------
This module never assumes it is "the driver" -- identity comes from the
environment/flags, and every mode runs the *same* training code:

* **Single-controller** (default): ``REPRO_RANK`` unset/0, no ``--spmd``.
  The process runs the Trainer over ``REPRO_TRANSPORT`` (``inproc``
  default; ``mp`` spawns passive-target worker processes that host the
  window partitions while this process issues all operations; ``tcp``
  spawns a loopback fleet, or joins the ``REPRO_HOSTS`` roster).
* **SPMD** (``--spmd``): this process becomes a pure launcher/monitor.
  A :class:`~repro_torch.core.transport.spmd.SpmdLauncher` spawns
  ``REPRO_NRANKS``/``--nranks`` worker processes, ships them
  :func:`_spmd_entry`, and each rank runs the Trainer itself on
  ``--device`` -- diffing its own device state, issuing its own puts,
  committing its own checkpoint manifest.  The launcher only heartbeats
  and respawns dead ranks (``rebuild_rank`` re-enters ``_spmd_entry`` on
  the fresh process, which restores from its own checkpoint); it issues
  zero data-path operations, and says so on exit.
* **Externally-launched worker** (``REPRO_RANK>0``, no ``--spmd``): some
  scheduler already placed N copies of this command.  The communicator
  bootstraps a rank-local view (``ranklocal`` transport): this process
  materializes only its own window partitions, with file naming identical
  to every other mode, and runs the same Trainer code path as rank 0.
  With ``REPRO_TRANSPORT=tcp`` and a ``REPRO_HOSTS`` roster the process
  instead *joins* the inter-host tcp fleet as an origin rank.
* **Mesh** (``--mesh [--multi-pod]``): one process per card, started by
  ``python -m torch.distributed.run`` (or any launcher that sets
  ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``).  Each
  process joins the default process group (NCCL on the card, gloo under
  ``--device cpu``), builds the production mesh (``REPRO_MESH_OVERRIDE``
  sets its shape) and ``train_rules(multi_pod)``, and trains inside
  ``use_rules``: each rank holds the reference's block of every
  parameter, moment and batch (``Trainer``'s mesh: data and tensor
  parallelism, the experts, FSDP; the sequence's split over "model" where
  the rules map the activations' "seq").  After the run rank 0 prints
  ``sharding_report()`` (the divisibility fallbacks, left replicated, and
  the "model" gathers where a block splits what the math needs whole or a
  module reads every position) and ``rank 0 state_bytes: N``, the bytes
  of the parameters, moments and batch it held in a step.  Each process is also a window
  rank (``REPRO_RANK``/``REPRO_NRANKS`` follow
  ``RANK``/``WORLD_SIZE`` unless they are set; the ``ranklocal``
  transport unless ``--transport`` or ``REPRO_TRANSPORT`` names
  another), so each saves its own block into its own checkpoint
  partition.  ``--mesh`` with ``--spmd`` is refused.

On-disk checkpoint layout is byte-identical across all three modes (and to
the JAX package's), so a job may crash under one bootstrap and resume
under another.  A resumed Trainer reads the batches from its restored step
on: the JAX package's launcher restarts its data at batch 0, so a resumed
rank there does not repeat the run it resumes.  On the card every mode runs
under deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` is set before
CUDA starts), so a resumed rank repeats an uninterrupted one bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --device cpu --spmd --nranks 2 --steps 4
    REPRO_MESH_OVERRIDE=2x2 PYTHONPATH=src python -m torch.distributed.run \\
        --nproc-per-node 4 -m repro_torch.launch.train --mesh \\
        --arch deepseek-v2-236b --smoke --device cpu --steps 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from ..configs import ARCHS, OFFLOAD_ARCHS, get_config
from ..convert import resolve_device
from ..core.comm import Communicator
from ..core.transport import env_nranks, env_rank, env_transport_kind
from ..data import SyntheticLM, make_batch_iter
from ..runtime.sharding import (mesh_shape, sharding_report, train_rules,
                                use_rules)
from ..train import AdamWConfig, TrainConfig, Trainer
from .mesh import make_production_mesh


def _train_opts(args) -> dict:
    """The picklable subset of CLI options an SPMD rank needs."""
    return {
        "arch": args.arch, "smoke": args.smoke, "layers": args.layers,
        "steps": args.steps,
        "batch": args.batch, "seq": args.seq,
        "microbatches": args.microbatches, "lr": args.lr,
        "ckpt_dir": args.ckpt_dir, "ckpt_every": args.ckpt_every,
        "mode": args.mode, "compression": args.compression,
        "probe_interval": args.probe_interval, "device": args.device,
    }


def _build_trainer(opts: dict, comm: Communicator, cfg=None, *, mesh=None,
                   rules=None) -> tuple[Trainer, SyntheticLM]:
    """The Trainer (over ``mesh`` and ``rules`` when given) and its data for
    ``opts``; ``cfg`` replaces the config of ``opts["arch"]`` (a caller
    that cuts its depth)."""
    if cfg is None:
        cfg = get_config(opts["arch"], smoke=opts["smoke"])
        if opts.get("layers"):
            cfg = dataclasses.replace(cfg, n_layers=opts["layers"])
    mode = opts["mode"] or ("offload" if opts["arch"] in OFFLOAD_ARCHS
                            and not opts["smoke"] else "fused")
    opt = AdamWConfig(lr=opts["lr"],
                      warmup_steps=max(1, opts["steps"] // 10),
                      total_steps=opts["steps"])
    tc = TrainConfig(steps=opts["steps"], microbatches=opts["microbatches"],
                     mode=mode, ckpt_dir=opts["ckpt_dir"],
                     ckpt_every=opts["ckpt_every"],
                     compression=opts["compression"],
                     log_every=5 if comm.rank == 0 else 0,
                     probe_interval_s=opts["probe_interval"])
    ds = SyntheticLM(cfg, batch=opts["batch"], seq=opts["seq"],
                     microbatches=opts["microbatches"])
    return Trainer(cfg, opt, tc, comm=comm, device=opts["device"],
                   mesh=mesh, rules=rules), ds


class _Batches:
    """The dataset's batches from the step ``trainer`` restored (0 on a
    fresh start), read when iteration begins: ``Trainer.run`` restores
    before it draws its first batch."""

    def __init__(self, trainer: Trainer, ds: SyntheticLM):
        self.trainer = trainer
        self.ds = ds

    def __iter__(self):
        step = self.trainer.restored_step or 0
        while True:
            yield self.ds.batch_at(step)
            step += 1


def _deterministic(device) -> None:
    """Exact repeats on the card: deterministic algorithms (cuBLAS reads
    its workspace setting when it makes its handle, at the first matrix
    product, so the variable is set here, before any)."""
    if resolve_device(device).type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)


def _spmd_entry(comm: Communicator, opts: dict, *, cfg=None,
                on_step=None) -> dict:
    """What every SPMD rank runs -- and re-enters after ``rebuild_rank``.

    The rank builds its own Trainer on ``opts["device"]`` over the
    communicator view the worker bootstrap handed it, restores from its own
    manifest if one exists (exact resume after a mid-run kill), trains, and
    reports a summary.  ``cfg`` replaces the config of ``opts["arch"]``;
    ``on_step(trainer, step, record)`` follows each step.  A Trainer that
    cannot be built on the device fails the rank: nothing retries on the
    CPU.
    """
    _deterministic(opts["device"])
    tr, ds = _build_trainer(opts, comm, cfg)
    hook = None if on_step is None else (
        lambda step, rec: on_step(tr, step, rec))
    tr.run(make_batch_iter(_Batches(tr, ds)), on_step=hook)
    log = tr.metrics_log
    summary = {
        "rank": comm.rank,
        "steps_run": len(log),
        "first_step": log[0]["step"] if log else None,
        "resumed_from": tr.restored_step,
        "final_loss": log[-1]["loss"] if log else None,
        "losses": [m["loss"] for m in log],
        "step_s": [m["time"] for m in log],
        "restore_ms": [r["ms"] for r in tr.ckpt.restore_records]
        if tr.ckpt else [],
        "device": str(tr.device),
    }
    if tr.device.type == "cuda":
        summary["peak_device_bytes"] = torch.cuda.max_memory_allocated(
            tr.device)
    tr.close()
    return summary


def _run_spmd(args) -> list[dict]:
    from ..core.transport.spmd import SpmdLauncher
    resolve_device(args.device)  # no ranks spawned for a missing card
    nranks = args.nranks or env_nranks(default=2)
    launcher = SpmdLauncher(nranks, _spmd_entry, (_train_opts(args),))
    try:
        results = launcher.monitor_until_done(
            interval_s=max(0.1, args.probe_interval))
        for res in results:
            loss = res["final_loss"]
            print(f"rank {res['rank']}: {res['steps_run']} step(s) from "
                  f"step {res['first_step']} on {res['device']}, final "
                  f"loss {loss!r}", flush=True)
        assert launcher.data_ops() == 0, "launcher issued data-path ops"
        print(f"spmd done: {nranks} rank(s), launcher data ops: "
              f"{launcher.data_ops()}", flush=True)
        return results
    finally:
        launcher.shutdown()


def _report(tr: Trainer, comm: Communicator) -> None:
    """The run's done line and its every loss (``repr``: exact)."""
    losses = [m["loss"] for m in tr.metrics_log]
    first = tr.metrics_log[0]["step"] if tr.metrics_log else 0
    dev = tr.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"rank {comm.rank}/{comm.size} done: "
          f"{len(losses)} step(s) from step {first}"
          + (f", loss {losses[0]!r} -> {losses[-1]!r}" if losses else "")
          + f" ({name}, transport={comm.transport.kind})", flush=True)
    print(f"rank {comm.rank} losses: {json.dumps(losses)}", flush=True)
    if dev.type == "cuda":
        print(f"rank {comm.rank} peak device bytes: "
              f"{torch.cuda.max_memory_allocated(dev)}", flush=True)


def _run_mesh(args) -> int:
    """``--mesh``: this process is one rank of the production mesh."""
    import torch.distributed as dist

    dev = resolve_device(args.device)
    _deterministic(args.device)
    owns_group = not dist.is_initialized()
    if owns_group:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    comm = None
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device=args.device)
        rules = train_rules(args.multi_pod)
        comm = Communicator(
            env_nranks(dist.get_world_size()),
            rank=env_rank(dist.get_rank()),
            transport=args.transport or env_transport_kind("ranklocal"))
        tr, ds = _build_trainer(_train_opts(args), comm, mesh=mesh,
                                rules=rules)
        with use_rules(rules, mesh):
            tr.run(make_batch_iter(_Batches(tr, ds)))
        _report(tr, comm)
        if dist.get_rank() == 0:
            print(f"mesh {mesh_shape(mesh)} "
                  f"({dist.get_backend()}), rules {rules.name}; "
                  "sharding_report (mappings left replicated): "
                  + json.dumps(sharding_report()), flush=True)
            print(f"rank 0 state_bytes: {tr.state_bytes}", flush=True)
        tr.close()
    finally:
        if comm is not None:
            comm.close()
        if owns_group:
            dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers, its "
                         "widths kept")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--mode", choices=("fused", "offload"), default=None)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--mesh", action="store_true",
                    help="one rank of the production mesh: start one process "
                         "per card under python -m torch.distributed.run")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --mesh, the (pod, data, model) mesh")
    ap.add_argument("--spmd", action="store_true",
                    help="launch REPRO_NRANKS/--nranks application ranks; "
                         "this process only monitors and respawns")
    ap.add_argument("--transport",
                    choices=("inproc", "mp", "ranklocal", "tcp"),
                    default=None,
                    help="window transport (default: $REPRO_TRANSPORT or "
                         "inproc; ignored under --spmd).  tcp joins the "
                         "REPRO_HOSTS fleet when a roster is set, else "
                         "spawns a loopback fleet")
    ap.add_argument("--nranks", type=int, default=None,
                    help="communicator size (default: $REPRO_NRANKS or 1; "
                         "2 under --spmd)")
    ap.add_argument("--probe-interval", type=float, default=1.0,
                    help="failure-detector probe interval in seconds")
    ap.add_argument("--device", default="cuda",
                    help="where every rank's Trainer allocates (default "
                         "cuda; cpu is the only way to the CPU)")
    args = ap.parse_args(argv)

    if args.mesh:
        if args.spmd:
            raise SystemExit("--mesh is refused under --spmd: a mesh is one "
                             "process per card, started by "
                             "python -m torch.distributed.run")
        return _run_mesh(args)

    if args.spmd:
        if env_rank() != 0:
            raise SystemExit("--spmd is driver-only: worker ranks are "
                             "spawned by the launcher, not self-started")
        _run_spmd(args)
        return 0

    # single-controller or externally-launched worker rank: from_env
    # resolves the identity (a nonzero REPRO_RANK gets a rank-local view)
    _deterministic(args.device)
    comm = Communicator.from_env(transport=args.transport,
                                 nranks=args.nranks)
    try:
        tr, ds = _build_trainer(_train_opts(args), comm)
        tr.run(make_batch_iter(_Batches(tr, ds)))
        _report(tr, comm)
        tr.close()
    finally:
        comm.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
