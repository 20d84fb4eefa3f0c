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

Under a mesh (``mesh=``, ``rules=``; one process per card, see
``launch.mesh``) the trainer is data- and expert-parallel: every rank
starts from the same seeded full parameters and keeps its block
(:func:`~repro_torch.runtime.sharding.explicit_spec`: the routed experts'
E/n rows over "model", everything else whole), takes its rows of each
global batch (row-major over the batch axes, ``("pod", "data")``), and
averages the summed gradients over the data axes with
``hierarchical_pmean`` before the update; the global norm counts each
whole tensor once and sums the experts' squares over "model".  Each rank
checkpoints its own block through its own communicator rank.
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
from ..runtime.collectives import axis_groups, hierarchical_pmean
from ..runtime.compress import compress_with_feedback, init_error_feedback
from ..runtime.fault import HeartbeatMonitor, StragglerDetector
from ..runtime.sharding import (NamedSharding, batch_axes, explicit_spec,
                                mesh_shape, train_rules, use_rules)
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
        # the tensors sharded over the mesh and the groups the global norm
        # sums their squares over: none without a mesh
        self.sharded, self.norm_groups = [], ()
        if mesh is not None:
            self._set_mesh()
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
        """Each tensor's block (recording every mapping left unapplied in
        ``sharding_report()``), the batch axes and the groups the global
        norm sums the sharded tensors' squares over."""
        mesh = self.mesh
        if self.rules is None:
            self.rules = train_rules("pod" in mesh_shape(mesh))
        data_axes = batch_axes(mesh, self.rules)
        if set(data_axes) - {"pod", "data"}:
            raise NotImplementedError(
                f"the batch shards over {data_axes}: this trainer averages "
                "gradients over ('pod', 'data') only (ROADMAP A14c)")
        self.shardings = {
            k: NamedSharding(mesh, explicit_spec(s.axes, s.shape, self.rules,
                                                 mesh, context=k))
            for k, s in self.specs.items()}
        self.sharded = sorted(k for k, sh in self.shardings.items()
                              if any(sh.spec))
        axes = sorted({a for k in self.sharded
                       for part in self.shardings[k].spec if part
                       for a in ((part,) if isinstance(part, str) else part)})
        self.norm_groups = axis_groups(mesh, axes)
        if self.sharded and self.tcfg.compression:
            raise NotImplementedError(
                "int8 compression takes one scale per whole tensor; "
                f"{self.sharded[0]} is sharded over the mesh (ROADMAP A14c)")

    def local_batch(self, batch: dict[str, np.ndarray]) -> dict:
        """This rank's rows of a global batch (leading microbatch axis, then
        the batch axis): the whole batch without a mesh."""
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
        """The gradients' mean over the data axes: one float32 buffer in
        sorted key order, padded to a multiple of the "data" axis' size,
        through ``hierarchical_pmean`` (inner "data", outer "pod")."""
        keys = sorted(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in keys])
        n_in = mesh_shape(self.mesh)["data"]
        pad = -flat.numel() % n_in
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        outer = "pod" if "pod" in mesh_shape(self.mesh) else None
        flat = hierarchical_pmean(flat, "data", outer, self.mesh)
        out, at = {}, 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[at:at + n].view(grads[k].shape)
            at += n
        return out

    # -- the step -----------------------------------------------------------
    def loss_and_grads(self, params, batch):
        """Mean loss and gradients over the batch's leading microbatch
        axis (tensors on the trainer's device): summed in float32 from zero, then divided by
        ``tcfg.microbatches`` (a true division, as the reference's).  Under
        a mesh, ``batch`` is this rank's rows, the loss the global one and
        the gradients their mean over the data axes."""
        if self.mesh is not None:
            with use_rules(self.rules, self.mesh):
                loss, grads = self._loss_and_grads(params, batch)
            return loss, self._data_mean(grads)
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
        """The fused mode's device update: the global norm (summed over the
        mesh for the sharded tensors) and AdamW.  Returns (params,
        opt_state, stats)."""
        gnorm = global_norm(grads, sharded=self.sharded,
                            groups=self.norm_groups)
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
        ``params`` is the full tree and ``data_iter`` the global batches:
        the rank keeps its blocks and rows, and returns its blocks."""
        tcfg = self.tcfg
        dev = self.device
        if params is None:
            params = init_params(self.specs, tcfg.seed, device=dev)
        params = {k: v.to(dev) for k, v in params.items()}
        if self.mesh is not None:  # this rank's block of the full tree
            params = {k: self.shardings[k].local_slice(v).clone()
                      for k, v in params.items()}
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
            t0 = time.monotonic()
            loss, grads = self.loss_and_grads(params, batch)
            if tcfg.mode == "fused":
                if tcfg.compression:
                    grads, ef = compress_with_feedback(grads, ef)
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
