"""``launch/train.py --mesh`` on four CPU processes: data, tensor and
expert parallelism and FSDP in training, held to a single-process
reckoning and to the JAX package's step.

Four gloo ranks run ``repro_torch.launch.train.main`` with ``--mesh
--device cpu`` (``RANK``/``WORLD_SIZE``/``MASTER_*`` set as
``torch.distributed.run`` sets them) on a (2, 2) ``("data", "model")`` mesh
(``REPRO_MESH_OVERRIDE=2x2``) and a (2, 1, 2) ``("pod", "data", "model")``
one (``--multi-pod``, ``2x1x2``), each mesh's runs (``RUNS``: an arch and
its rules, ``train_rules`` with tensor parallelism ("tp"), with
``seq_shard=True`` beside it ("sp") or with ``tp=False`` ("no_tp"), the
launcher's ``train_rules`` patched in the rank) in one set of processes,
at the smoke configs in float32,
the MoE's capacity factor raised to E/k so that no assignment drops.  On
2x2 under tensor parallelism: internlm2 (dense GQA), deepseek-v2 (MLA and
the expert-parallel MoE), mamba2 (the fused ``in_proj`` block straddles
z | xBC | dt), recurrentgemma (its one kv head splits over "model"; the
RG-LRU gates read the gathered conv output) and whisper (the encoder and
cross-attention); under sequence parallelism (the residual stream split
along its positions over "model" between the regions) internlm2,
deepseek-v2 (the MoE on the gathered positions), mamba2, recurrentgemma
and llava (the patch prefix's rows in the first rank's block);
``tp=False`` (the batch over both axes, FSDP over both) for internlm2 and
whisper; on 2x1x2 internlm2 and deepseek-v2, and internlm2 and whisper
under ``tp=False`` (the batch over "pod" and "data", FSDP over all three
axes, token parallelism: each rank's positions over "model", the keys
and values gathered).  Every
rank holds the reference's block of every parameter, moment and batch,
and every block's input is its rows of its positions.
The batch's rows mask 0, 1, 5 and 9 leading targets, so the data shards
mask different numbers.  Each rank records the loss's ``ce`` metric, its
parameters and gradients after every step (``make_loss_fn``,
``adamw_update`` and ``Trainer.loss_and_grads`` wrapped in the rank).

* Each step's ``ce``, gradients and parameters (the ranks' blocks put
  together by their ``logical_to_spec`` specs) equal a single-process
  reckoning of the same objective from the ranks' parameters before the
  step -- the global CE plus ``MOE_AUX_WEIGHT`` times the mean over the
  data shards of each shard's aux (what the reference's ``pmean``
  computes) -- through the port's dense model code and ``adamw_update``,
  at 1e-5 relative (``_check_reckoning`` says why each step starts from
  the ranks' parameters).
* The first step's ``ce``, loss, gradients (their mean over the batch
  axes, the blocks put together) and global norm equal the JAX package's
  ``--mesh`` train step on the same mesh under the same rules
  (``Trainer``'s loss, its gradient and the ``global_norm`` its step
  clips by, under ``use_rules`` on four forced host devices, in a
  subprocess run beside the ranks) from the same parameters and batch, at
  1e-5 relative.  The parameters after that step are held to the
  reckoning above, not to the reference: AdamW's first step moves each
  element by lr * g / (|g| + eps), so the two frameworks' 1e-6 gradient
  difference on an element with |g| near 1e-7 moves it by a few percent
  of lr.
* Each rank's parameters, both moments and its checkpoint window's
  tensors have exactly its blocks' shapes under ``logical_to_spec``, and
  its ``rank 0 state_bytes`` line is their bytes and its batch's.
* A 4-step run with a checkpoint every 2 steps, stopped after 2 (the
  rank's ``Trainer.run`` given ``stop_after=2``, as a kill would stop it)
  and restarted on the same mesh, continues bit for bit.
* ``--compression`` on 2x2: each tensor's int8 scale is the whole
  tensor's, and the run equals the single-process reckoning with the same
  compression.
* ``chip_smoke.py`` phase 9m's routines on the CPU: at one rank, the
  expert-parallel prefill equals the dense one and ``--mesh`` training
  equals the run without it, bit for bit; and the launcher's refusals.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_collectives import (MESHES, ROOT,  # noqa: F401
                                    finish_reference, one_thread, run_ranks,
                                    start_reference)

# the runs of the sequence's split over "model"
SEQ_SPLIT = {
    "2x2": (("internlm2-1.8b", "sp"), ("deepseek-v2-236b", "sp"),
            ("mamba2-2.7b", "sp"), ("recurrentgemma-2b", "sp"),
            ("llava-next-mistral-7b", "sp")),
    "2x1x2": (("internlm2-1.8b", "no_tp"), ("whisper-base", "no_tp")),
}
# mesh -> the (arch, rules) runs its ranks train, in order: rules "tp"
# (train_rules), "sp" (seq_shard=True) or "no_tp" (tp=False)
RUNS = {
    "2x2": (("internlm2-1.8b", "tp"), ("deepseek-v2-236b", "tp"),
            ("mamba2-2.7b", "tp"), ("recurrentgemma-2b", "tp"),
            ("whisper-base", "tp"), ("internlm2-1.8b", "no_tp"),
            ("whisper-base", "no_tp")) + SEQ_SPLIT["2x2"],
    "2x1x2": (("internlm2-1.8b", "tp"), ("deepseek-v2-236b", "tp"),
              ("internlm2-1.8b", "no_tp"), ("whisper-base", "no_tp")),
}
# the runs held to the JAX package's first step
REFERENCE_RUNS = {
    "2x2": (("internlm2-1.8b", "tp"), ("deepseek-v2-236b", "tp"),
            ("mamba2-2.7b", "tp"), ("recurrentgemma-2b", "tp"),
            ("internlm2-1.8b", "no_tp"), ("whisper-base", "no_tp"))
    + SEQ_SPLIT["2x2"],
    "2x1x2": RUNS["2x1x2"],
}
# the runs stopped after 2 steps and resumed
RESUMED = {"2x2": (("deepseek-v2-236b", "tp"), ("mamba2-2.7b", "tp"),
                   ("internlm2-1.8b", "no_tp")) + SEQ_SPLIT["2x2"],
           "2x1x2": RUNS["2x1x2"]}
COMPRESSED = ("internlm2-1.8b", "tp")  # on 2x2
# (mesh, arch, rules, kind) -> the parameters whose free-running reckoning
# drifts past TOL from the ranks' (_check_reckoning); PERF.md has the
# readings
FREE_DRIFT = {
    ("2x2", "mamba2-2.7b", "tp", "whole"): {"g0/p0/dt_bias"},
    ("2x2", "mamba2-2.7b", "sp", "whole"): {"g0/p0/dt_bias"},
    ("2x2", "recurrentgemma-2b", "tp", "whole"): {
        "g0/p0/b_r", "g0/p0/norm2", "g0/p1/b_i", "g0/p1/norm1"},
    ("2x2", "recurrentgemma-2b", "sp", "whole"): {
        "g0/p0/b_r", "g0/p0/norm2", "g0/p1/b_i", "g0/p1/norm1"},
    ("2x2", "whisper-base", "tp", "whole"): {"embed/tok", "g0/p0/wq"},
    ("2x2", "internlm2-1.8b", "no_tp", "whole"): {"g0/p0/norm1"},
    ("2x2", "internlm2-1.8b", "tp", "compressed"): {
        "g0/p0/mlp_wg", "g0/p0/mlp_wi", "g0/p0/mlp_wo"},
}
STEPS, BATCH, SEQ = 4, 4, 16
MASKED = (0, 1, 5, 9)  # leading targets masked in each row of the batch
TOL = 1e-5


def _id(run) -> str:
    return f"{run[0]}-{run[1]}"


def rules_kw(rules: str) -> dict:
    """``train_rules``' keywords for a run's rules."""
    return {"tp": rules != "no_tp", "seq_shard": rules == "sp"}


def config(name: str, *, smoke: bool = False):
    """The test's config: float32, the MoE's capacity factor E/k."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(name, smoke=smoke),
                              dtype="float32", param_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def masked_lm():
    from repro_torch.data import SyntheticLM

    class MaskedLM(SyntheticLM):
        """SyntheticLM with MASKED[b] more targets masked in row b."""

        def batch_at(self, step):
            out = super().batch_at(step)
            for b, n in enumerate(MASKED):
                out["targets"][:, b, :n] = -1
            return out
    return MaskedLM


def train_worker(arg) -> None:
    """One rank: each run of its mesh through ``launch.train.main`` (the
    uninterrupted run, and for RESUMED ones the stopped and restarted
    pair), then an offload run and, on 2x2, a compressed one."""
    directory, mesh = arg
    import torch.distributed as dist

    import repro_torch.launch.train as launch
    import repro_torch.models.lm as lm
    import repro_torch.train.loop as loop

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    rec: dict = {}
    make_loss_fn, adamw_update = loop.make_loss_fn, loop.adamw_update

    def recording_loss_fn(cfg):
        fn = make_loss_fn(cfg)

        def loss_fn(params, batch):
            loss, metrics = fn(params, batch)
            rec["loss"].append(float(loss.detach()))
            rec["ce"].append(float(metrics["ce"].detach()))
            return loss, metrics
        return loss_fn

    def recording_update(*args, **kw):
        out = adamw_update(*args, **kw)
        rec["params"].append({k: v.clone() for k, v in out[0].items()})
        rec["gnorm"].append(float(out[2]["gnorm"]))
        return out

    loss_and_grads = loop.Trainer.loss_and_grads
    block_train = lm._block_train

    def recording_block_train(cfg, kind, p, x, *args):
        rec["block_in"].add(tuple(x.shape))
        return block_train(cfg, kind, p, x, *args)

    def recording_loss_and_grads(self, params, batch):
        loss, grads = loss_and_grads(self, params, batch)
        rec["grads"].append({k: v.clone() for k, v in grads.items()})
        return loss, grads

    run = loop.Trainer.run

    def stoppable_run(self, *args, **kw):
        params, opt = run(self, *args, stop_after=stop_after, **kw)
        rec["held"] = {
            "params": {k: tuple(v.shape) for k, v in params.items()},
            "moments": None if opt is None else {
                k: (tuple(opt["m"][k].shape), tuple(opt["v"][k].shape))
                for k in opt["m"]},
            "window": None if self.ckpt is None else {
                k: tuple(v[0]) for k, v in self.ckpt.specs.items()},
            "state_bytes": self.state_bytes}
        return params, opt

    loop.make_loss_fn, loop.adamw_update = recording_loss_fn, recording_update
    loop.Trainer.run = stoppable_run
    loop.Trainer.loss_and_grads = recording_loss_and_grads
    lm._block_train = recording_block_train
    launch.get_config, launch.SyntheticLM = config, masked_lm()
    train_rules = launch.train_rules
    launch.train_rules = lambda multi_pod=False: train_rules(
        multi_pod, **rules_kw(rules))
    out = {}
    common = ["--mesh", "--smoke", "--device", "cpu", "--batch", str(BATCH),
              "--seq", str(SEQ), "--probe-interval", "0.2"]
    if len(MESHES[mesh][1]) == 3:
        common.append("--multi-pod")

    def main(argv, ckpt):
        rec.update(loss=[], ce=[], params=[], gnorm=[], grads=[],
                   block_in=set())
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            assert launch.main(argv + ["--ckpt-dir", ckpt]) == 0
        return {**rec, "stdout": text.getvalue()}

    for arch, rules in RUNS[mesh]:
        argv = common + ["--arch", arch, "--steps", str(STEPS),
                         "--ckpt-every", "2"]
        base = f"{directory}/{_id((arch, rules))}"
        stop_after = None
        out[arch, rules, "whole"] = main(argv, f"{base}/a")
        if (arch, rules) in RESUMED[mesh]:
            for name, stop_after in (("stopped", 2), ("resumed", None)):
                out[arch, rules, name] = main(argv, f"{base}/b")
    # offload mode: the out-of-core AdamW walks this rank's own blocks
    stop_after, rules = None, "tp"
    out["offload"] = main(common + ["--arch", "deepseek-v2-236b", "--steps",
                                    "2", "--mode", "offload"],
                          f"{directory}/offload")
    if mesh == "2x2":
        out["compressed"] = main(common + [
            "--arch", COMPRESSED[0], "--steps", str(STEPS),
            "--compression"], f"{directory}/compressed")
    torch.save(out, Path(directory) / f"rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(mesh)``: the mesh's runs, trained once each in this module
    (:func:`_train_mesh`)."""
    done: dict = {}

    def get(mesh: str):
        if mesh not in done:
            done[mesh] = _train_mesh(mesh, tmp_path_factory)
        return done[mesh]
    return get


def _train_mesh(mesh: str, tmp_path_factory):
    """The mesh, each rank's records, and the JAX package's first steps on
    that mesh from the same parameters and batch (run beside the ranks)."""
    from repro_torch.models import init_params, param_specs
    tmp = tmp_path_factory.mktemp(f"mesh_train_{mesh}")
    inp = {}
    for arch in sorted({a for a, _ in REFERENCE_RUNS[mesh]}):
        cfg = config(arch, smoke=True)
        params = init_params(param_specs(cfg), 0, device="cpu")
        inp.update({f"{arch}/params/{k}": v.numpy()
                    for k, v in params.items()})
        inp.update({f"{arch}/batch/{k}": v for k, v in
                    masked_lm()(cfg, batch=BATCH, seq=SEQ).batch_at(0).items()})
    np.savez(tmp / "inputs.npz", **inp)
    shape, axes = MESHES[mesh]
    reference = start_reference(
        _REFERENCE_STEP % {"shape": shape, "axes": axes,
                           "runs": REFERENCE_RUNS[mesh]},
        str(tmp / "inputs.npz"), str(tmp / "ref.npz"), log=tmp / "ref.log")
    try:
        run_ranks("test_torch_mesh_train", "train_worker", (str(tmp), mesh),
                  env={"REPRO_MESH_OVERRIDE": mesh}, timeout=300)
    finally:
        finish_reference(reference, tmp / "ref.log", timeout=400)
    return (mesh, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                   for r in range(4)], dict(np.load(tmp / "ref.npz")))


def _check_reckoning(mesh, results, run, *, kind="whole",
                     compression=False) -> None:
    """The ranks' run (``kind``) against a single-process reckoning, two
    ways.  A step of the reckoning: each data shard's CE sum and aux
    through the dense model code, the global CE plus MOE_AUX_WEIGHT times
    the mean of the shards' aux, its gradients, then the update
    (int8-compressed with error feedback, with ``compression``) by AdamW
    as the launcher configures it, the moments and the error feedback
    carried from step to step.

    * Stepwise: each step from the ranks' parameters before it (the blocks
      put together; the seeded ones at step 0), the update from the ranks'
      gradients.  ``ce``, every gradient and every parameter after the
      step at 1e-5 relative.
    * Free: the reckoning's own trajectory from the seeded parameters over
      all the steps.  ``ce`` and every parameter after each step at 1e-5
      relative, but the tensors ``FREE_DRIFT`` names for the run, which
      the stepwise check still holds.  AdamW's update lr * m / (sqrt(v) +
      eps) moves an element whose gradient is near eps by a step that a
      float reordering of its gradient changes in its leading digits, so
      run free the 1e-7 noise of summing in another order grows past
      1e-5 on such elements of these tensors (zero-initialised norms,
      mamba2's ``dt_bias``); PERF.md records the readings."""
    from repro_torch.models import (MOE_AUX_WEIGHT, init_params, make_loss_fn,
                                    param_specs)
    from repro_torch.runtime.compress import (compress_with_feedback,
                                              init_error_feedback)
    from repro_torch.train import AdamWConfig, adamw_update, init_opt_state
    arch, rules = run
    cfg = config(arch, smoke=True)
    n_dp = _n_dp(mesh, rules)
    res = [{(*run, "whole"): rec[(*run, kind)]} for rec in results]
    params = init_params(param_specs(cfg), 0, device="cpu")
    opt = AdamWConfig(lr=3e-4, warmup_steps=max(1, STEPS // 10),
                      total_steps=STEPS)
    state, ef = init_opt_state(params), init_error_feedback(params)
    free = params, state, ef
    loss_fn = make_loss_fn(cfg)
    ds = masked_lm()(cfg, batch=BATCH, seq=SEQ)
    rows = BATCH // n_dp

    def reckon(params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        ce_sum = ntok = aux = 0
        for d in range(n_dp):
            _, m = loss_fn(leaves, {k: torch.from_numpy(
                np.ascontiguousarray(v[0, d * rows:(d + 1) * rows]))
                for k, v in batch.items()})
            ce_sum = ce_sum + m["ce"] * m["ntok"]
            ntok = ntok + m["ntok"]
            aux = aux + m["aux"] / n_dp
        ce = ce_sum / ntok
        loss = ce + MOE_AUX_WEIGHT * aux if cfg.n_experts else ce
        return float(ce.detach()), dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))

    def update(params, grads, state, ef):
        if compression:
            grads, ef = compress_with_feedback(grads, ef)
        params, state, _ = adamw_update(params, grads, state, opt)
        return params, state, ef

    drift = {}
    for step in range(STEPS):
        batch = ds.batch_at(step)
        ce, want = reckon(params, batch)
        for rec in res:
            np.testing.assert_allclose(rec[(*run, "whole")]["ce"][step], ce,
                                       rtol=TOL)
        grads = _assembled(mesh, res, run, step, kind="grads")
        for name, g in want.items():
            assert _rel(grads[name], g) < TOL, ("grad", name, step,
                                                _rel(grads[name], g))
        want, state, ef = update(params, grads, state, ef)
        params = _assembled(mesh, res, run, step)
        for name, p in want.items():
            assert _rel(params[name], p) < TOL, (name, step,
                                                 _rel(params[name], p))
        # the free trajectory
        ce, grads = reckon(free[0], batch)
        for rec in res:
            np.testing.assert_allclose(rec[(*run, "whole")]["ce"][step], ce,
                                       rtol=TOL)
        free = update(free[0], grads, *free[1:])
        for name, p in free[0].items():
            err = _rel(params[name], p)
            if err >= TOL:
                drift[name] = max(err, drift.get(name, 0.0))
    assert set(drift) <= FREE_DRIFT.get((mesh, *run, kind), set()), drift


# the JAX package's --mesh train step on the same mesh under the same
# rules, from the port's initial parameters and first batch (npz keys
# "<arch>/params/<name>" and "<arch>/batch/<name>"): the first step's ce
# (the loss's metric), loss, gradients (one microbatch: the step's own) and
# their global norm (what its fused step clips by), traced under the rules
# as the step is
_REFERENCE_STEP = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.runtime.sharding import train_rules, use_rules
from repro.train.loop import TrainConfig, Trainer
from repro.train.optimizer import AdamWConfig, global_norm

shape, axes, runs = %(shape)r, %(axes)r, %(runs)r
inp = dict(np.load(sys.argv[1]))
# Auto axes: jax 0.9's make_mesh makes Explicit ones, which the
# reference's shard() (with_sharding_constraint) refuses
mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
out = {}
for arch, kind in runs:
    rules = train_rules(len(axes) == 3, tp=kind != "no_tp",
                        seq_shard=kind == "sp")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              param_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)

    def part(kind):
        head = f"{arch}/{kind}/"
        return {k[len(head):]: jnp.asarray(v) for k, v in inp.items()
                if k.startswith(head)}
    params, batch = part("params"), part("batch")
    tr = Trainer(cfg, AdamWConfig(), TrainConfig(), mesh=mesh, rules=rules)

    def step(params, batch):
        (loss, metrics), grads = jax.value_and_grad(
            tr.loss_fn, has_aux=True)(params, batch)
        return loss, metrics, grads, global_norm(grads)
    with use_rules(rules, mesh):
        loss, metrics, grads, gnorm = jax.jit(step)(
            params, {k: v[0] for k, v in batch.items()})
    key = f"{arch}/{kind}"
    out[f"{key}/ce"] = np.asarray(metrics["ce"])
    out[f"{key}/loss"] = np.asarray(loss)
    out[f"{key}/gnorm"] = np.asarray(gnorm)
    out.update({f"{key}/grads/{k}": np.asarray(v) for k, v in grads.items()})
np.savez(sys.argv[2], **out)
"""


def _coords(mesh: str, rank: int) -> dict[str, int]:
    """Rank -> its coordinate on each mesh axis (row-major)."""
    shape, axes = MESHES[mesh]
    out = {}
    for a, n in zip(reversed(axes), reversed(shape)):
        out[a], rank = rank % n, rank // n
    return out


def _specs(mesh: str, arch: str, rules: str) -> dict:
    """Each parameter's full shape and its block's ``NamedSharding`` under
    ``logical_to_spec`` with the run's rules, on a shape-only mesh."""
    from repro_torch.models import param_specs
    from repro_torch.runtime.sharding import (NamedSharding, logical_to_spec,
                                              train_rules)
    shape, axes = MESHES[mesh]
    m = SimpleNamespace(shape=dict(zip(axes, shape)))
    table = train_rules(len(axes) == 3, **rules_kw(rules))
    return {k: (s.shape, NamedSharding(m, logical_to_spec(
        s.axes, s.shape, table, m))) for k, s in
        param_specs(config(arch, smoke=True)).items()}


def _assembled(mesh, results, run, step, kind="params") -> dict:
    """The ranks' parameters (or gradients, ``kind``) at ``step``, whole:
    each rank's block put in its place, and every rank's block equal to
    the whole tensor's at its place (a block held by several ranks is the
    same on each)."""
    out = {}
    for name, (shape, sh) in _specs(mesh, *run).items():
        whole = torch.full(shape, float("nan"))
        blocks = [rec[(*run, "whole")][kind][step][name] for rec in results]
        for r, blk in enumerate(blocks):
            sh.local_slice(whole, _coords(mesh, r)).copy_(blk)
        for r, blk in enumerate(blocks):
            assert torch.equal(sh.local_slice(whole, _coords(mesh, r)),
                               blk), (name, r)
        out[name] = whole
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / max(1e-12, float(b.abs().max())))


def _n_dp(mesh: str, rules: str) -> int:
    """The data-parallel size: the batch over ("data",) or ("pod",
    "data"), or over ("data", "model") on 2x2 without tensor
    parallelism."""
    return 4 if mesh == "2x2" and rules == "no_tp" else 2


CASES = [(mesh, run) for mesh in RUNS for run in RUNS[mesh]]


@pytest.mark.parametrize("mesh,run", CASES,
                         ids=[f"{m}-{_id(r)}" for m, r in CASES])
def test_mesh_training_matches_single_process_reckoning(ranks, mesh, run):
    mesh, results, _ = ranks(mesh)
    for rec in results:
        got = rec[(*run, "whole")]
        assert len(got["ce"]) == len(got["params"]) == STEPS
    _check_reckoning(mesh, results, run)


REF_CASES = [(mesh, run) for mesh in REFERENCE_RUNS
             for run in REFERENCE_RUNS[mesh]]


@pytest.mark.parametrize("mesh,run", REF_CASES,
                         ids=[f"{m}-{_id(r)}" for m, r in REF_CASES])
def test_mesh_training_matches_reference_step(ranks, mesh, run):
    """The first step against the JAX package's on the same mesh under the
    same rules: ``ce``, the loss (the aux term included), the global norm
    and every gradient after the mean over the batch axes."""
    mesh, results, ref = ranks(mesh)
    key = f"{run[0]}/{run[1]}"
    for rec in results:
        got = rec[(*run, "whole")]
        np.testing.assert_allclose(got["ce"][0], ref[f"{key}/ce"], rtol=TOL)
        np.testing.assert_allclose(got["loss"][0], ref[f"{key}/loss"],
                                   rtol=TOL)
        np.testing.assert_allclose(got["gnorm"][0], ref[f"{key}/gnorm"],
                                   rtol=TOL)
    head = f"{key}/grads/"
    names = {k[len(head):] for k in ref if k.startswith(head)}
    got = _assembled(mesh, results, run, 0, kind="grads")
    assert names == set(got)
    for name in sorted(names):
        want = torch.from_numpy(ref[head + name])
        assert _rel(got[name], want) < TOL, (name, _rel(got[name], want))


@pytest.mark.parametrize("mesh,run", CASES,
                         ids=[f"{m}-{_id(r)}" for m, r in CASES])
def test_mesh_ranks_hold_their_blocks(ranks, mesh, run):
    """Each rank's parameters, both AdamW moments and its checkpoint
    window's tensors have its blocks' shapes under ``logical_to_spec``
    (the bytes the reference's layout gives a device), and rank 0's
    ``state_bytes`` line counts them and its batch rows."""
    mesh, results, _ = ranks(mesh)
    specs = _specs(mesh, *run)
    want = {k: sh.shard_shape(shape) for k, (shape, sh) in specs.items()}
    for rec in results:
        held = rec[(*run, "whole")]["held"]
        assert held["params"] == want
        assert held["moments"] == {k: (v, v) for k, v in want.items()}
        assert {k: held["window"][k] for k in want} == want
        assert {k: held["window"][f"opt_{m}/{k}"] for k in want
                for m in "mv"} == {k: v for k, v in want.items()}
    cfg = config(run[0], smoke=True)
    rows = BATCH // _n_dp(mesh, run[1])
    batch = masked_lm()(cfg, batch=BATCH, seq=SEQ).batch_at(0)
    batch_bytes = sum(v[:, :rows].nbytes for v in batch.values())
    param_bytes = sum(math.prod(v) * (4 + 4 + 4) for v in want.values())
    text = results[0][(*run, "whole")]["stdout"]
    line = re.findall(r"^rank 0 state_bytes: (\d+)$", text, re.M)
    assert line == [str(param_bytes + batch_bytes + 4)], (line, text[-500:])


@pytest.mark.parametrize("mesh,run",
                         [(m, r) for m in RESUMED for r in RESUMED[m]],
                         ids=[f"{m}-{_id(r)}" for m in RESUMED
                              for r in RESUMED[m]])
def test_mesh_training_resumes_bit_for_bit(ranks, mesh, run):
    _, results, _ = ranks(mesh)
    for rec in results:
        whole, stopped, resumed = (rec[(*run, k)] for k in
                                   ("whole", "stopped", "resumed"))
        assert stopped["loss"] == whole["loss"][:2]
        assert resumed["loss"] == whole["loss"][2:], (resumed["loss"],
                                                      whole["loss"])
        assert "from step 2" in resumed["stdout"]
        for name, t in whole["params"][-1].items():
            assert torch.equal(resumed["params"][-1][name], t), name
        assert resumed["held"] == whole["held"]


def test_mesh_compression_matches_reckoning(ranks):
    """``--compression`` under tensor parallelism and FSDP: each gradient's
    int8 scale is the whole tensor's (the block's maximum all-reduced over
    the axes it spans), so the compressed run equals the single-process
    reckoning with the same compression: ``ce``, the gradients and the
    parameters at 1e-5."""
    mesh, results, _ = ranks("2x2")
    res = [{(*COMPRESSED, "compressed"): rec["compressed"]}
           for rec in results]
    _check_reckoning(mesh, res, COMPRESSED, kind="compressed",
                     compression=True)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_offload_mode_trains_each_block(ranks, mesh):
    """``--mode offload`` under the mesh: ``OutOfCoreAdamW`` (elementwise,
    no global norm) updates each rank's own blocks from the averaged
    gradients; every rank reports the same finite global losses."""
    _, results, _ = ranks(mesh)
    losses = [rec["offload"]["loss"] for rec in results]
    assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))
    assert all(got == losses[0] for got in losses)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_prints_the_sharding_report(ranks, mesh):
    """Rank 0 prints the mesh and ``sharding_report()`` after each run: no
    mapping of the training rules is left unapplied (the activations'
    "seq" of multi-pod ``tp=False`` and ``seq_shard=True`` splits the
    stream, 16 and 24 positions dividing by 2: no fallback under
    "activations"), and each gather over "model" of what the reference's
    layout keeps sharded is named once: on 2x2 mamba2's fused projection,
    recurrentgemma's one kv head and its RG-LRU gates, and under sequence
    parallelism the MoE's dispatch on every position; on 2x1x2 (token
    parallelism) the keys and values over the positions, in
    self-attention and in whisper's cross-attention."""
    mesh, results, _ = ranks(mesh)
    runs = RUNS[mesh]
    text = results[0][(*runs[-1], "whole")]["stdout"]
    line = next(ln for ln in text.splitlines() if "sharding_report" in ln)
    assert "(gloo), rules train" in line and "A14" not in line
    report = json.loads(line.split("replicated): ", 1)[1])
    assert "not applied" not in json.dumps(report)
    assert "activations" not in report
    every = ("the stream gathered over 'model' along its positions "
             "(model=2): every position computed on each rank")
    if mesh == "2x1x2":
        positions = ("k and v gathered over 'model' along the positions "
                     "(model=2): each rank's queries attend every key")
        assert report["attention/self"] == [positions]
        assert report["attention/x_"] == [positions]
    if mesh == "2x2":
        assert report["ssm/in_proj"] == [
            "in_proj's z | xBC | dt block on model=2 straddles its parts: "
            "its output gathered over 'model'"]
        assert report["attention/self"] == [
            "1 kv heads on model=2: k and v gathered over 'model', each "
            "rank takes the kv heads of its queries"]
        assert list(report["rglru/gates"]) == [
            "the gates' columns on model=2 read every channel: the conv "
            "output gathered over 'model'"]
        assert report["moe/dispatch"] == [every]
    for rec in results[1:]:
        assert "sharding_report" not in rec[(*runs[-1], "whole")]["stdout"]


SPLIT_CASES = [(mesh, run) for mesh in SEQ_SPLIT for run in SEQ_SPLIT[mesh]]


@pytest.mark.parametrize("mesh,run", SPLIT_CASES,
                         ids=[f"{m}-{_id(r)}" for m, r in SPLIT_CASES])
def test_mesh_blocks_take_the_ranks_positions(ranks, mesh, run):
    """Under ``seq_shard=True`` and multi-pod ``tp=False`` every block's
    input on every rank (``_block_train``'s stream, the encoder's too) is
    its rows of its block of the positions, (rows, S/m, D): no rank holds
    the whole sequence of the residual stream.  (A VLM's stream of SEQ
    positions is its 8 patches and 8 text tokens: the patches are the
    first rank's block, the text the second's.)"""
    mesh, results, _ = ranks(mesh)
    cfg = config(run[0], smoke=True)
    want = {(BATCH // _n_dp(mesh, run[1]), SEQ // 2, cfg.d_model)}
    for rec in results:
        for kind in ("whole", "resumed"):
            assert rec[(*run, kind)]["block_in"] == want, (kind, want)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mesh_prefill_phase_at_smoke_widths(chip_smoke):
    """Phase 9m (a) on the CPU: 9c's smoke model through the dense and the
    expert-parallel prefill on a one-rank gloo group: equal bit for bit."""
    cfg = chip_smoke.phase9_config("9c", smoke=True)
    params = chip_smoke.model_params(cfg, 0, torch.device("cpu"))
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 13)).astype(np.int32)
    out = chip_smoke.mesh_prefill(cfg, params, prompt, "cpu")
    assert out["logits_equal"] and out["mesh"] == {"data": 1, "model": 1}
    assert out["backend"] == "gloo"
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_mesh_training_phase_on_cpu(chip_smoke):
    """Phase 9m (b) on the CPU, at the smoke config: ``--mesh`` under
    torchrun with one process (the tensor-parallel and FSDP code at one
    rank) against the run without it, losses bit-equal, and the bytes rank
    0 held equal to the dry-run's for the same cell."""
    out = chip_smoke.mesh_training("cpu", smoke=True)
    assert out["losses_equal"] and len(out["losses"]) == \
        chip_smoke.MESH_PHASE["steps"]
    assert out["state_bytes"] == out["dryrun_state_bytes"] > 0
    assert "peak_device_bytes" not in out


def _run(*args: str, env: dict | None = None) -> subprocess.CompletedProcess:
    base = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    base.update(PYTHONPATH=str(ROOT / "src"), **(env or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=base, capture_output=True, text=True,
                          timeout=120)


def test_mesh_refuses_spmd_and_a_missing_card():
    args = ["--mesh", "--arch", "internlm2-1.8b", "--smoke", "--steps", "1"]
    r = _run(*args, "--spmd", "--device", "cpu")
    assert r.returncode != 0 and "--mesh is refused under --spmd" in r.stderr
    if not torch.cuda.is_available():
        r = _run(*args)  # --device cuda, the default
        assert r.returncode != 0
        assert "CUDA is not available" in r.stderr


def test_remat_recompute_keeps_the_mesh():
    """A remat unit recomputes its layer in the backward, which on the card
    runs on the autograd engine's own thread, where ``use_rules`` (thread
    local) is not set: the unit re-enters the rules it was built under, so
    the recomputed MoE takes the expert-parallel path again.  Here the
    backward runs on another thread, at one rank, remat "full": the path
    is taken twice per MoE layer and the gradients equal remat "none"'s."""
    import threading

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params, make_loss_fn, moe, param_specs
    from repro_torch.runtime import train_rules, use_rules
    base = config("deepseek-v2-236b", smoke=True)
    params = init_params(param_specs(base), 0, device="cpu")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[0])) for k, v in
             masked_lm()(base, batch=BATCH, seq=SEQ).batch_at(0).items()}
    n_moe = sum(r * p.count("moe") for r, p in base.groups())
    calls = []
    ep = moe._moe_mlp_shard_map
    moe._moe_mlp_shard_map = lambda *a, **kw: calls.append(1) or ep(*a, **kw)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    grads = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        for remat in ("none", "full"):
            cfg = dataclasses.replace(base, remat=remat)
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            with use_rules(train_rules(), mesh):
                loss, _ = make_loss_fn(cfg)(leaves, batch)
            out = []
            worker = threading.Thread(target=lambda: out.append(
                torch.autograd.grad(loss, list(leaves.values()))))
            worker.start()
            worker.join()
            grads[remat] = out[0]
    finally:
        moe._moe_mlp_shard_map = ep
        dist.destroy_process_group()
    assert len(calls) == n_moe + 2 * n_moe
    for a, b in zip(grads["none"], grads["full"]):
        assert torch.equal(a, b)
