"""Training loop with windows-backed transparent checkpointing.

The counterpart of ``repro.train.loop``.  The loop wires every substrate
together:

* the train step: gradients summed over microbatches in float32 and then
  divided (the reference's ``lax.scan``), optional int8 + error-feedback
  compression, AdamW on the device -- or, in *offload* mode, a grads-only
  device step plus the out-of-core AdamW walking storage windows (the
  paper's technique as the optimizer).  Gradients come from autograd
  through the plain PyTorch loss, as the reference's come from XLA: no
  kernel of either package has a backward.
* transparent checkpointing: params (+ fused opt state) live in an A/B
  double-buffered CheckpointManager; saves are selective (dirty pages
  only) and asynchronous (flush overlaps the next steps).
* fault hooks: heartbeats + failure and straggler detectors on every step;
  ``Trainer.run`` restores from the last valid manifest, so a kill at any
  point resumes exactly.

The step is functional, as the reference's jitted step is: each update
makes new tensors, so a flush still in flight never reads memory that a
later step writes.  The trainer runs on ``device`` (``"cuda"`` unless the
caller asks for another) and, like ``Engine``, turns TF32 off for the
process, so float32 configs compute in float32.  On the card a resumed
run repeats the uninterrupted one bit for bit only under deterministic
algorithms (the backward of the embedding's ``index_select`` and of the
loss's ``gather`` otherwise accumulate with atomics): the caller sets
``CUBLAS_WORKSPACE_CONFIG`` before CUDA starts and calls
``torch.use_deterministic_algorithms(True)``, as ``launch.train_e2e`` does.

Under a mesh (``mesh=``, ``rules=``, a :func:`~repro_torch.runtime.
sharding.train_rules` table; one process per card, see ``launch.mesh``)
each rank holds the reference's block of every parameter, of both AdamW
moments and of the batch (:func:`~repro_torch.runtime.sharding.
explicit_spec`: data parallelism over the batch axes, tensor parallelism
and the experts over "model", FSDP over the data axes, or over every axis
under ``tp=False``).  It makes its block one tensor at a time from the
seeded initialisation, takes its rows of each global batch (row-major
over the batch axes), and computes the step on its blocks
(:mod:`~repro_torch.runtime.partition`); where the rules map the
activations' "seq", the model takes the rank's positions of those rows
(sequence parallelism beside tensor parallelism, token parallelism
without it).  Each gradient is then averaged per tensor over the token
axes (``token_axes``: the batch axes, and the sequence's axis under
token parallelism): an FSDP block's gather already reduce-scattered it
as a mean over its gathered axes, and the mean over the token axes left
("pod") follows; a tensor held whole over them goes through
``hierarchical_pmean``.  The global norm sums each tensor's squares over
exactly the axes its block spans, and int8 compression takes each whole
tensor's scale (an all-reduce max over the same axes).  Each rank
checkpoints its own blocks through its own communicator rank.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..ckpt import CheckpointManager
from ..convert import exact_float32, resolve_device, tensor_from_stored
from ..core.comm import Communicator
from ..core.resilience import FailureDetector
from ..models import init_params, make_loss_fn, param_specs
from ..models.config import ModelConfig
from ..perf.op_analysis import storage_bytes
from ..runtime.collectives import axis_groups, hierarchical_pmean
from ..runtime.compress import compress_with_feedback, init_error_feedback
from ..runtime.fault import HeartbeatMonitor, StragglerDetector
from ..runtime.partition import gather_plan, reduction_axes
from ..runtime.sharding import (NamedSharding, explicit_spec,
                                is_train_rules, mesh_shape, spec_axes,
                                token_axes, train_rules, use_rules)
from .offload_opt import OutOfCoreAdamW
from .optimizer import (_f32, AdamWConfig, adamw_update, global_norm,
                        init_opt_state)

__all__ = ["TrainConfig", "Trainer"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    mode: str = "fused"            # fused | offload
    ckpt_dir: str | None = None
    ckpt_every: int = 0
    ckpt_async: bool = True
    compression: bool = False      # int8 + error feedback on grads
    log_every: int = 10
    seed: int = 0
    # FailureDetector probe rate-limit (seconds): SPMD runs and tests
    # tighten it to catch rank death quickly; 1s keeps probing off the
    # hot path in production
    probe_interval_s: float = 1.0


class Trainer:
    def __init__(self, model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainConfig, *, comm: Communicator | None = None,
                 device: str | torch.device = "cuda", mesh=None,
                 rules=None):
        self.device = resolve_device(device)
        exact_float32()
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.comm = comm or Communicator(1)
        self.loss_fn = make_loss_fn(model_cfg)
        self.specs = param_specs(model_cfg)
        self.mesh = mesh
        self.rules = rules
        # name -> the process groups of the mesh axes its block spans (the
        # global norm and the int8 scale reduce over them): none without a
        # mesh
        self.spans: dict[str, list] = {}
        if mesh is not None:
            self._set_mesh()
        # the bytes of the parameters, moments and batch held in the last
        # run's first step (None until one runs)
        self.state_bytes: int | None = None
        self.metrics_log: list[dict[str, float]] = []
        self.hb = HeartbeatMonitor(self.comm.size)
        # probe-driven liveness: under the mp, spmd and tcp transports the
        # other ranks are real processes, and only Transport.probe can
        # observe their death.  interval rate-limits the actual probing so
        # the per-step poll() stays off the hot path
        self.detector = FailureDetector(self.comm, self.hb,
                                        interval=tcfg.probe_interval_s)
        self.straggler = StragglerDetector(self.comm.size)
        # the checkpoint manager and the out-of-core optimizer of the last
        # run() (None until a run makes them)
        self.ckpt: CheckpointManager | None = None
        self.offload_opt: OutOfCoreAdamW | None = None
        # step of the manifest run() restored from (None = fresh start)
        self.restored_step: int | None = None

    # -- the mesh -----------------------------------------------------------
    def _set_mesh(self):
        """Each tensor's block (``explicit_spec``), what the step gathers of
        it (its plan), and the groups its block spans."""
        mesh = self.mesh
        if self.rules is None:
            self.rules = train_rules("pod" in mesh_shape(mesh))
        if not is_train_rules(self.rules):
            raise ValueError(f"the trainer runs under train_rules, not "
                             f"{self.rules.name}")
        self.shardings = {
            k: NamedSharding(mesh, explicit_spec(s.axes, s.shape, self.rules,
                                                 mesh, context=k))
            for k, s in self.specs.items()}
        self.plans = {k: gather_plan(s.axes, self.shardings[k].spec)
                      for k, s in self.specs.items()}
        self.spans = {k: axis_groups(mesh, spec_axes(sh.spec))
                      for k, sh in self.shardings.items()
                      if spec_axes(sh.spec)}

    def local_batch(self, batch: dict[str, np.ndarray]) -> dict:
        """This rank's rows of a global batch (leading microbatch axis, then
        the batch axis): the whole batch without a mesh.  Each row keeps
        every position: where the rules map "seq", the model takes the
        rank's positions of them."""
        if self.mesh is None:
            return batch
        out = {}
        for k, v in batch.items():
            axes = (None, "batch") + (None,) * (v.ndim - 2)
            spec = explicit_spec(axes, v.shape, self.rules, self.mesh,
                                 context=f"batch/{k}")
            out[k] = NamedSharding(self.mesh, spec).local_slice(v)
        return out

    def _data_mean(self, grads: dict) -> dict:
        """The mean over the token axes of gradients held whole over them:
        one float32 buffer in sorted key order, padded to a multiple of the
        "data" axis' size, through ``hierarchical_pmean`` (inner "data",
        outer the first other token axis, if any), then an all-reduce mean
        over each further one (token parallelism's "model")."""
        keys = sorted(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        n_in = mesh_shape(self.mesh)["data"]
        pad = -flat.numel() % n_in
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        outer = [a for a in token_axes(self.mesh, self.rules) if a != "data"]
        flat = hierarchical_pmean(flat, "data", outer[0] if outer else None,
                                  self.mesh)
        for g in axis_groups(self.mesh, outer[1:]):
            torch.distributed.all_reduce(flat, group=g)
            flat = flat / torch.distributed.get_world_size(g)
        out, at = {}, 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[at:at + n].view(grads[k].shape)
            at += n
        return out

    def _reduce_grads(self, grads: dict) -> dict:
        """Each gradient's mean over the token axes: a tensor the step does
        not gather through :meth:`_data_mean`; an FSDP block, whose gather's
        backward already took the mean over its gathered axes, over the
        token axes left (one all-reduce per set of them, the tensors in
        sorted key order)."""
        whole, left, out = {}, {}, {}
        for k in sorted(grads):
            if not self.plans[k]:
                whole[k] = grads[k]
                continue
            axes = reduction_axes(self.plans[k], self.mesh, self.rules)
            if axes:
                left.setdefault(axes, []).append(k)
            else:
                out[k] = grads[k]
        if whole:
            out.update(self._data_mean(whole))
        for axes, keys in left.items():
            flat = torch.cat([grads[k].reshape(-1) for k in keys])
            n = 1
            for g in axis_groups(self.mesh, axes):
                torch.distributed.all_reduce(flat, group=g)
                n *= torch.distributed.get_world_size(g)
            flat, at = flat / n, 0
            for k in keys:
                out[k] = flat[at:at + grads[k].numel()].view(grads[k].shape)
                at += grads[k].numel()
        return out

    # -- the step -----------------------------------------------------------
    def loss_and_grads(self, params, batch):
        """Mean loss and gradients over the batch's leading microbatch
        axis (tensors on the trainer's device): summed in float32 from zero, then divided by
        ``tcfg.microbatches`` (a true division, as the reference's).  Under
        a mesh, ``batch`` is this rank's rows, the loss the global one and
        the gradients their mean over the token axes."""
        if self.mesh is not None:
            with use_rules(self.rules, self.mesh):
                loss, grads = self._loss_and_grads(params, batch)
            return loss, self._reduce_grads(grads)
        return self._loss_and_grads(params, batch)

    def _loss_and_grads(self, params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        l_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        g_sum = {k: torch.zeros(v.shape, dtype=torch.float32,
                                device=self.device)
                 for k, v in params.items()}
        for i in range(next(iter(batch.values())).shape[0]):
            loss, _ = self.loss_fn(leaves, {k: v[i] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, list(leaves.values()))
            l_sum = l_sum + loss.detach()
            g_sum = {k: g_sum[k] + g for k, g in zip(leaves, grads)}
        n = _f32(self.tcfg.microbatches, self.device)
        return l_sum / n, {k: v / n for k, v in g_sum.items()}

    def update(self, params, opt_state, grads):
        """The fused mode's device update: the global norm (each sharded
        tensor's squares summed over the axes its block spans) and AdamW.
        Returns (params, opt_state, stats)."""
        gnorm = global_norm(grads, spans=self.spans)
        return adamw_update(params, grads, opt_state, self.opt_cfg,
                            gnorm=gnorm)

    # -- checkpoint plumbing ------------------------------------------------
    def _ckpt_specs(self, params) -> dict[str, tuple[tuple[int, ...], Any]]:
        out = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
        if self.tcfg.mode == "fused":
            for k, v in params.items():
                out[f"opt_m/{k}"] = (tuple(v.shape), torch.float32)
                out[f"opt_v/{k}"] = (tuple(v.shape), torch.float32)
            out["opt_step"] = ((), torch.int32)
        return out

    def _ckpt_tree(self, params, opt_state):
        tree = dict(params)
        if self.tcfg.mode == "fused":
            tree.update({f"opt_m/{k}": v for k, v in opt_state["m"].items()})
            tree.update({f"opt_v/{k}": v for k, v in opt_state["v"].items()})
            tree["opt_step"] = opt_state["step"]
        return tree

    def _restore(self, params, opt_state):
        """(step, params, opt_state) of the last valid checkpoint, or the
        given ones at step 0 when there is none."""
        res = self.ckpt.restore()
        if res is None:
            return 0, params, opt_state

        def stored(name):
            return tensor_from_stored(res.tree[name],
                                      self.ckpt.specs[name][1], self.device)

        params = {k: stored(k) for k in self.specs}
        if self.tcfg.mode == "fused":
            opt_state = {"m": {k: stored(f"opt_m/{k}") for k in self.specs},
                         "v": {k: stored(f"opt_v/{k}") for k in self.specs},
                         "step": stored("opt_step")}
        self.restored_step = res.step
        return res.step, params, opt_state

    # -- main entry -----------------------------------------------------------
    def run(self, data_iter: Iterator[dict[str, np.ndarray]],
            params: dict | None = None, *, restore: bool = True,
            stop_after: int | None = None,
            on_step: Callable[[int, dict], None] | None = None,
            on_save: Callable[[int, dict], None] | None = None):
        """Train from ``params`` (tensors; by default ``init_params`` of the
        config from ``tcfg.seed``) or from the last checkpoint, to step
        ``tcfg.steps`` or for ``stop_after`` steps.  ``data_iter`` yields
        numpy batches with a leading microbatch axis.  ``on_step(step,
        record)`` follows each step; ``on_save(step, tree)`` precedes each
        checkpoint save with the tree about to be saved.  Returns (params,
        opt_state); opt_state is None in offload mode.  Under a mesh,
        ``params`` is the full tree (on any device) and ``data_iter`` the
        global batches: the rank keeps its blocks and rows, and returns its
        blocks; a tensor reaches the device as its block, one at a time."""
        tcfg = self.tcfg
        dev = self.device

        def block(k, v):
            if self.mesh is None:
                return v.to(dev)
            return self.shardings[k].local_slice(v).to(
                dev, copy=True).contiguous()

        if params is None:
            params = init_params(self.specs, tcfg.seed, device=dev,
                                 block=block)
        else:
            params = {k: block(k, v) for k, v in params.items()}
        if tcfg.mode == "fused":
            opt_state = init_opt_state(params)
        else:
            shapes = {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
            self.offload_opt = OutOfCoreAdamW(
                self.comm, shapes,
                tcfg.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                              "repro_torch_opt"),
                self.opt_cfg)
            self.offload_opt.initialize(params)
            params = {k: torch.from_numpy(v).to(dev, torch.bfloat16)
                      for k, v in self.offload_opt.masters().items()}
            opt_state = None
        ef = init_error_feedback(params) if tcfg.compression else None

        start_step = 0
        if tcfg.ckpt_dir and tcfg.ckpt_every:
            self.ckpt = CheckpointManager(tcfg.ckpt_dir, self.comm,
                                          self._ckpt_specs(params))
            if restore:
                start_step, params, opt_state = self._restore(params,
                                                              opt_state)

        end = tcfg.steps if stop_after is None else min(tcfg.steps,
                                                        start_step + stop_after)
        for step in range(start_step, end):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in self.local_batch(next(data_iter)).items()}
            if self.state_bytes is None:
                self.state_bytes = storage_bytes(
                    [*params.values(), *batch.values()]
                    + ([] if opt_state is None else
                       [*opt_state["m"].values(), *opt_state["v"].values(),
                        opt_state["step"]]))
            t0 = time.monotonic()
            loss, grads = self.loss_and_grads(params, batch)
            if tcfg.mode == "fused":
                if tcfg.compression:
                    grads, ef = compress_with_feedback(grads, ef,
                                                       spans=self.spans)
                params, opt_state, stats = self.update(params, opt_state,
                                                       grads)
            else:
                new_p = self.offload_opt.update(
                    {k: g.to(torch.bfloat16) for k, g in grads.items()})
                # update() returns only the keys present in grads (sparse/MoE
                # updates skip the rest) -- merge, never replace wholesale
                params = {**params,
                          **{k: torch.from_numpy(v).to(dev, torch.bfloat16)
                             for k, v in new_p.items()}}
                stats = {"lr": 0.0, "gnorm": 0.0}
            del grads
            rec = {"step": step, "loss": float(loss),
                   "time": time.monotonic() - t0, "lr": float(stats["lr"])}
            self.hb.beat(self.comm.rank, step)
            self.detector.poll(step)
            self.straggler.record(self.comm.rank, rec["time"])
            self.metrics_log.append(rec)
            if on_step:
                on_step(step, rec)
            if tcfg.log_every and step % tcfg.log_every == 0:
                print(f"step {step:5d} loss {rec['loss']:.4f} "
                      f"({rec['time'] * 1e3:.0f} ms)", flush=True)
            if self.ckpt and (step + 1) % tcfg.ckpt_every == 0:
                tree = self._ckpt_tree(params, opt_state)
                if on_save:
                    on_save(step + 1, tree)
                if tcfg.ckpt_async:
                    self.ckpt.save_async(step + 1, tree)
                else:
                    self.ckpt.save(step + 1, tree)
            if self.offload_opt is not None and tcfg.ckpt_every \
                    and (step + 1) % tcfg.ckpt_every == 0:
                self.offload_opt.sync()

        if self.ckpt:
            self.ckpt.wait()
        return params, opt_state

    def close(self):
        if self.ckpt:
            self.ckpt.close()
        if self.offload_opt:
            self.offload_opt.free()
