"""``launch/train.py --mesh`` on four CPU processes: data- and
expert-parallel training held to a single-process reckoning.

Four gloo ranks run ``repro_torch.launch.train.main`` with ``--mesh
--device cpu`` (``RANK``/``WORLD_SIZE``/``MASTER_*`` set as
``torch.distributed.run`` sets them) on a (2, 2) ``("data", "model")`` mesh
(``REPRO_MESH_OVERRIDE=2x2``) and a (2, 1, 2) ``("pod", "data", "model")``
one (``--multi-pod``, ``2x1x2``), for the deepseek-v2 (MoE: its experts
split over "model") and internlm2 smoke configs in float32, the MoE's
capacity factor raised to E/k so that no assignment drops.  The batch's
rows mask 0, 1, 5 and 9 leading targets, so the two data shards mask
different numbers.  Each rank records the loss's ``ce`` metric and its
parameters after every step (``make_loss_fn`` and ``adamw_update``
wrapped in the rank).

* ``ce`` and the parameters (the experts' blocks put together) after each
  step equal a single-process reckoning of the same objective -- the
  global CE plus ``MOE_AUX_WEIGHT`` times the mean over the data shards of
  each shard's aux (what the reference's ``pmean`` computes) -- through
  the port's dense model code and ``adamw_update``, at 1e-5 relative.
* The first step's ``ce``, loss, gradients (their mean over the data
  axes, the experts' blocks put together) and global norm equal the JAX
  package's ``--mesh`` train step on the same mesh (``Trainer``'s loss,
  its gradient and the ``global_norm`` its step clips by, under
  ``use_rules(train_rules, mesh)`` on four forced host devices, in a
  subprocess run beside the ranks) from the same parameters and batch,
  at 1e-5 relative: the CE summed over shards that
  mask different counts, the aux ``pmean`` and the norm with the experts'
  squares summed over "model" are the reference's.  The parameters after
  that step are held to the reckoning above, not to the reference: AdamW's
  first step moves each element by lr * g / (|g| + eps), so the two
  frameworks' 1e-6 gradient difference on an element with |g| near 1e-7
  moves it by a few percent of lr.
* A 4-step run with a checkpoint every 2 steps, stopped after 2 (the
  rank's ``Trainer.run`` given ``stop_after=2``, as a kill would stop it)
  and restarted on the same mesh, continues bit for bit.
* ``chip_smoke.py`` phase 9m's routines on the CPU: at one rank, the
  expert-parallel prefill equals the dense one and ``--mesh`` training
  equals the run without it, bit for bit; and the launcher's refusals.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import (MESHES, ROOT,  # noqa: F401
                                    finish_reference, one_thread, run_ranks,
                                    start_reference)

ARCHS = ("deepseek-v2-236b", "internlm2-1.8b")
STEPS, BATCH, SEQ = 4, 4, 16
MASKED = (0, 1, 5, 9)  # leading targets masked in each row of the batch
TOL = 1e-5


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
    """One rank: every arch's uninterrupted run (records) and its stopped
    and restarted pair, through ``launch.train.main``."""
    directory, mesh = arg
    import torch.distributed as dist

    import repro_torch.launch.train as launch
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

    def recording_loss_and_grads(self, params, batch):
        loss, grads = loss_and_grads(self, params, batch)
        rec["grads"].append({k: v.clone() for k, v in grads.items()})
        return loss, grads

    run = loop.Trainer.run

    def stoppable_run(self, *args, **kw):
        return run(self, *args, stop_after=stop_after, **kw)

    loop.make_loss_fn, loop.adamw_update = recording_loss_fn, recording_update
    loop.Trainer.run = stoppable_run
    loop.Trainer.loss_and_grads = recording_loss_and_grads
    launch.get_config, launch.SyntheticLM = config, masked_lm()
    out = {}
    common = ["--mesh", "--smoke", "--device", "cpu", "--batch", str(BATCH),
              "--seq", str(SEQ), "--probe-interval", "0.2"]
    if len(MESHES[mesh][1]) == 3:
        common.append("--multi-pod")
    for arch in ARCHS:
        argv = common + ["--arch", arch, "--steps", str(STEPS),
                         "--ckpt-every", "2"]
        for name, ckpt, stop_after in (("whole", "a", None),
                                       ("stopped", "b", 2),
                                       ("resumed", "b", None)):
            rec.update(loss=[], ce=[], params=[], gnorm=[], grads=[])
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                assert launch.main(
                    argv + ["--ckpt-dir", f"{directory}/{arch}/{ckpt}"]) == 0
            out[arch, name] = {**rec, "stdout": text.getvalue()}
    # offload mode: the out-of-core AdamW walks this rank's own block
    rec.update(loss=[], ce=[], params=[], gnorm=[], grads=[])
    stop_after = None
    with contextlib.redirect_stdout(io.StringIO()):
        assert launch.main(common + [
            "--arch", ARCHS[0], "--steps", "2", "--mode", "offload",
            "--ckpt-dir", f"{directory}/offload"]) == 0
    out["offload"] = dict(rec)
    torch.save(out, Path(directory) / f"rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, tmp_path_factory):
    """The mesh, each rank's records, and the JAX package's first step on
    that mesh from the same parameters and batch (run beside the ranks)."""
    from repro_torch.models import init_params, param_specs
    mesh = request.param
    tmp = tmp_path_factory.mktemp(f"mesh_train_{mesh}")
    inp = {}
    for arch in ARCHS:
        cfg = config(arch, smoke=True)
        params = init_params(param_specs(cfg), 0, device="cpu")
        inp.update({f"{arch}/params/{k}": v.numpy()
                    for k, v in params.items()})
        inp.update({f"{arch}/batch/{k}": v for k, v in
                    masked_lm()(cfg, batch=BATCH, seq=SEQ).batch_at(0).items()})
    np.savez(tmp / "inputs.npz", **inp)
    shape, axes = MESHES[mesh]
    reference = start_reference(
        _REFERENCE_STEP % {"shape": shape, "axes": axes, "archs": ARCHS},
        str(tmp / "inputs.npz"), str(tmp / "ref.npz"), log=tmp / "ref.log")
    try:
        run_ranks("test_torch_mesh_train", "train_worker", (str(tmp), mesh),
                  env={"REPRO_MESH_OVERRIDE": mesh}, timeout=240)
    finally:
        finish_reference(reference, tmp / "ref.log", timeout=360)
    return (mesh, [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                   for r in range(4)], dict(np.load(tmp / "ref.npz")))


def _reckoning(arch: str, n_dp: int) -> tuple[list, list]:
    """``ce`` and the parameters after each step, in one process: each data
    shard's CE sum and aux through the dense model code, the global CE plus
    MOE_AUX_WEIGHT times the mean of the shards' aux, and AdamW as the
    launcher configures it."""
    from repro_torch.models import (MOE_AUX_WEIGHT, init_params, make_loss_fn,
                                    param_specs)
    from repro_torch.train import AdamWConfig, adamw_update, init_opt_state
    cfg = config(arch, smoke=True)
    params = init_params(param_specs(cfg), 0, device="cpu")
    opt = AdamWConfig(lr=3e-4, warmup_steps=max(1, STEPS // 10),
                      total_steps=STEPS)
    state = init_opt_state(params)
    loss_fn = make_loss_fn(cfg)
    ds = masked_lm()(cfg, batch=BATCH, seq=SEQ)
    rows = BATCH // n_dp
    ces, trees = [], []
    for step in range(STEPS):
        batch = ds.batch_at(step)
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
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params, state, _ = adamw_update(params, dict(zip(leaves, grads)),
                                        state, opt)
        ces.append(float(ce.detach()))
        trees.append(params)
    return ces, trees


# the JAX package's --mesh train step on the same mesh, from the port's
# initial parameters and first batch (npz keys "<arch>/params/<name>" and
# "<arch>/batch/<name>"): the first step's ce (the loss's metric), loss,
# gradients (one microbatch: the step's own) and their global norm (what
# its fused step clips by), traced under the rules as the step is
_REFERENCE_STEP = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_config
from repro.runtime.sharding import train_rules, use_rules
from repro.train.loop import TrainConfig, Trainer
from repro.train.optimizer import AdamWConfig, global_norm

shape, axes, archs = %(shape)r, %(axes)r, %(archs)r
inp = dict(np.load(sys.argv[1]))
# Auto axes: jax 0.9's make_mesh makes Explicit ones, which the
# reference's shard() (with_sharding_constraint) refuses
mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
rules = train_rules(len(axes) == 3)
out = {}
for arch in archs:
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
    out[f"{arch}/ce"] = np.asarray(metrics["ce"])
    out[f"{arch}/loss"] = np.asarray(loss)
    out[f"{arch}/gnorm"] = np.asarray(gnorm)
    out.update({f"{arch}/grads/{k}": np.asarray(v) for k, v in grads.items()})
np.savez(sys.argv[2], **out)
"""


# rank -> (data index, model index): both test meshes have 2 data shards
# (over "data", or over "pod") and 2 model ranks, row-major
LAYOUT = {r: (r // 2, r % 2) for r in range(4)}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / max(1e-12, float(b.abs().max())))


def _assembled(results, arch: str, step: int, name: str, shape,
               kind: str = "params") -> torch.Tensor:
    """The ranks' parameter (or gradient, ``kind``) ``name`` at ``step``,
    whole: a tensor kept whole must be the same on every rank; the experts'
    blocks are put together over "model" (after the stacked layer axis)."""
    blocks = [results[r][arch, "whole"][kind][step][name]
              for r, (d, _) in LAYOUT.items() if d == 0]
    if tuple(blocks[0].shape) == tuple(shape):
        for rec in results:
            assert torch.equal(rec[arch, "whole"][kind][step][name],
                               blocks[0]), (name, step)
        return blocks[0]
    return torch.cat(blocks, dim=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_training_matches_single_process_reckoning(ranks, arch):
    _, results, _ = ranks
    ces, trees = _reckoning(arch, n_dp=2)
    for r, rec in enumerate(results):
        got = rec[arch, "whole"]
        assert len(got["ce"]) == len(got["params"]) == STEPS
        np.testing.assert_allclose(got["ce"], ces, rtol=TOL)
    for step in range(STEPS):
        for name, want in trees[step].items():
            got = _assembled(results, arch, step, name, want.shape)
            assert _rel(got, want) < TOL, (name, step, _rel(got, want))


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_training_matches_reference_step(ranks, arch):
    """The first step against the JAX package's on the same mesh: ``ce``,
    the loss (the aux term included), the global norm and every gradient
    after the data mean."""
    _, results, ref = ranks
    for rec in results:
        got = rec[arch, "whole"]
        np.testing.assert_allclose(got["ce"][0], ref[f"{arch}/ce"], rtol=TOL)
        np.testing.assert_allclose(got["loss"][0], ref[f"{arch}/loss"],
                                   rtol=TOL)
        np.testing.assert_allclose(got["gnorm"][0], ref[f"{arch}/gnorm"],
                                   rtol=TOL)
    head = f"{arch}/grads/"
    names = {k[len(head):] for k in ref if k.startswith(head)}
    assert names == set(results[0][arch, "whole"]["grads"][0])
    for name in sorted(names):
        want = torch.from_numpy(ref[head + name])
        got = _assembled(results, arch, 0, name, want.shape, kind="grads")
        assert _rel(got, want) < TOL, (name, _rel(got, want))


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_training_resumes_bit_for_bit(ranks, arch):
    _, results, _ = ranks
    for rec in results:
        whole, stopped, resumed = (rec[arch, k] for k in
                                   ("whole", "stopped", "resumed"))
        assert stopped["loss"] == whole["loss"][:2]
        assert resumed["loss"] == whole["loss"][2:], (resumed["loss"],
                                                      whole["loss"])
        assert "from step 2" in resumed["stdout"]
        for name, t in whole["params"][-1].items():
            assert torch.equal(resumed["params"][-1][name], t), name


def test_mesh_offload_mode_trains_each_block(ranks):
    """``--mode offload`` under the mesh: ``OutOfCoreAdamW`` (elementwise,
    no global norm) updates each rank's own block from the averaged
    gradients; every rank reports the same finite global losses."""
    _, results, _ = ranks
    losses = [rec["offload"]["loss"] for rec in results]
    assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))
    assert all(got == losses[0] for got in losses)


def test_mesh_prints_the_sharding_report(ranks):
    """Rank 0 prints the mesh and every mapping left replicated, naming
    A14c; the experts' "model" mapping is applied, so not among them."""
    mesh, results, _ = ranks
    text = results[0]["deepseek-v2-236b", "whole"]["stdout"]
    line = next(ln for ln in text.splitlines() if "sharding_report" in ln)
    assert "(gloo), rules train" in line and "A14c" in line
    assert "'experts' dim 8 -> ('model',)=2 not applied (the expert" in line
    assert "we_up\": [\"axis 'fsdp'" in line or "'ff'" in line
    for rec in results[1:]:
        assert "sharding_report" not in rec["deepseek-v2-236b",
                                            "whole"]["stdout"]


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
    torchrun with one process against the run without it, losses
    bit-equal."""
    out = chip_smoke.mesh_training("cpu", smoke=True)
    assert out["losses_equal"] and len(out["losses"]) == \
        chip_smoke.MESH_PHASE["steps"]
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
