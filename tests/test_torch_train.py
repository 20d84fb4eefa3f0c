"""The port's training path against the JAX package's.

Same numpy inputs (parameters from the reference's ``init_params``,
batches from ``SyntheticLM``) go through both packages; the port gets CPU
tensors.  Limits:

* ``blockwise_attention``: 2e-5 in float32 (``tests/test_kernels.py``'s
  attention limit), forward and gradients, over its masks and block
  edges.
* ``make_loss_fn``: the loss at 1e-5 relative, step 0's gradients at 1e-4
  of each tensor's largest |g|, in a float32 config; remat ``none``,
  ``full`` and ``dots`` must give the port the same bits.
* ``adamw_update`` / ``global_norm`` / ``init_opt_state``: the learning
  rate at ``LR_TOL`` (``tests/test_torch_offload_opt.py``: XLA's and
  PyTorch's float32 ``cos`` may differ in the last bit), params, m and v
  at 1e-6 relative.
* ``compress_with_feedback``: bit for bit (``round`` is half-to-even in
  both).
* the fault hooks: equal results (numpy code in both).
* the ``Trainer`` over 4 float32 steps with 2 microbatches: losses at 1e-4
  relative; every parameter within 2·lr per step (an Adam step moves an
  element by at most about lr, and a tiny gradient whose sign differs
  between the packages moves it the other way), and all but 0.1% within
  1e-5 + 1e-4·|p|.  In bf16, the losses at 2e-2.

The reference's Trainer tests (``tests/test_train_serve.py``: overfit,
exact restart, offload mode, compression) run on the port, the restart
held to the same bits with ``torch.equal``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import Communicator as JComm
from repro.core.resilience import FailureDetector as JFailureDetector
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import init_params as j_init_params
from repro.models import make_loss_fn as j_make_loss_fn
from repro.models import param_specs as j_param_specs
from repro.models.attention import blockwise_attention as j_blockwise
from repro.runtime import compress as jcompress
from repro.runtime import fault as jfault
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro.train import adamw_update as j_adamw_update
from repro.train import global_norm as j_global_norm
from repro.train import init_opt_state as j_init_opt_state
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import Communicator
from repro_torch.core.resilience import FailureDetector
from repro_torch.data import SyntheticLM
from repro_torch.models import make_loss_fn
from repro_torch.models.attention import blockwise_attention
from repro_torch.runtime import compress, fault
from repro_torch.train import (AdamWConfig, TrainConfig, Trainer,
                               adamw_update, global_norm, init_opt_state)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
LR_TOL = 4 * 2.0 ** -23  # learning-rate tolerance, relative to cfg.lr
STEPS = 4


def configs(dtype="float32", **kw):
    return (dataclasses.replace(j_get_config(ARCH, smoke=True), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype,
                                **kw))


def numpy_params(jcfg, seed=1):
    return {k: np.asarray(v) for k, v in j_init_params(
        j_param_specs(jcfg), jax.random.PRNGKey(seed)).items()}


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


# -- the training attention ----------------------------------------------------

@pytest.mark.parametrize("S,T,H,K,kw", [
    (40, 40, 4, 2, dict(causal=True)),
    (37, 37, 4, 1, dict(causal=True, q_block=16, kv_block=16)),
    (37, 37, 2, 2, dict(causal=True, window=9, q_block=16, kv_block=16)),
    (12, 30, 4, 2, dict(causal=True, q_offset=18, q_block=16, kv_block=16)),
    (20, 33, 4, 4, dict(causal=False, q_block=16, kv_block=16)),
], ids=["causal", "gqa_blocks", "window", "offset", "noncausal"])
def test_blockwise_attention_matches_reference(S, T, H, K, kw):
    rng = np.random.default_rng(S + T)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, S, H, 16), (2, T, K, 16), (2, T, K, 16)))
    w = rng.standard_normal((2, S, H, 16)).astype(np.float32)

    def j_obj(q, k, v):
        return (j_blockwise(q, k, v, **kw) * w).sum()

    want = np.asarray(j_blockwise(q, k, v, **kw))
    want_g = jax.grad(j_obj, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = blockwise_attention(tq, tk, tv, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-5,
                               rtol=2e-5)
    for g, wg in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=2e-5,
                                   rtol=2e-5)


# -- the loss -------------------------------------------------------------------

@pytest.fixture(scope="module")
def loss_case():
    jcfg, _ = configs()
    params = numpy_params(jcfg)
    b = JSyntheticLM(jcfg, batch=2, seq=40, seed=3).batch_at(0)
    batch = {k: v[0] for k, v in b.items()}
    batch["targets"][1, 5:9] = -1  # masked targets inside a row
    (loss, metrics), grads = jax.value_and_grad(
        j_make_loss_fn(jcfg), has_aux=True)(params, batch)
    return params, batch, float(loss), float(metrics["ntok"]), {
        k: np.asarray(v) for k, v in grads.items()}


def _port_loss(remat, params, batch):
    _, cfg = configs(remat=remat)
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(cfg, params, "cpu").items()}
    loss, metrics = make_loss_fn(cfg)(
        leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_reference(loss_case, remat):
    params, batch, want, ntok, want_g = loss_case
    loss, metrics, grads = _port_loss(remat, params, batch)
    assert _rel(loss, want) <= 1e-5
    assert float(metrics["ntok"]) == ntok
    assert float(metrics["aux"]) == 0.0
    for k, g in grads.items():
        scale = np.abs(want_g[k]).max()
        assert np.abs(g.numpy() - want_g[k]).max() <= 1e-4 * scale, k


def test_remat_does_not_change_a_bit(loss_case):
    params, batch = loss_case[:2]
    base_loss, _, base = _port_loss("none", params, batch)
    for remat in ("full", "dots"):
        loss, _, grads = _port_loss(remat, params, batch)
        assert torch.equal(loss, base_loss), remat
        for k in base:
            assert torch.equal(grads[k], base[k]), (remat, k)


@pytest.mark.parametrize("arch,item", [("mamba2-2.7b", "item 16"),
                                       ("recurrentgemma-2b", "item 16"),
                                       ("llama4-maverick-400b-a17b", "item 12"),
                                       ("whisper-base", "item 12")])
def test_untrained_kinds_raise_naming_their_item(arch, item):
    """Each family's training under the ROADMAP item that ports it: item
    16 (ssm, rglru and local_attn blocks) and item 12's MoE and MLA half
    are ported, so those configs build a loss and take a finite one (with
    the MoE load-balance term); item 12's frontends still raise, naming
    it."""
    jcfg = j_get_config(arch, smoke=True)
    if arch == "whisper-base":  # not a config of the port: its fields
        from repro_torch.models.config import ModelConfig
        cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(ModelConfig)})
        with pytest.raises(NotImplementedError, match=item):
            make_loss_fn(cfg)
        return
    cfg = get_config(arch, smoke=True)
    batch = SyntheticLM(cfg, batch=2, seq=16, seed=0).batch_at(0)
    params = params_from_numpy(cfg, numpy_params(jcfg), "cpu")
    loss, metrics = make_loss_fn(cfg)(
        params, {k: torch.from_numpy(v[0]) for k, v in batch.items()})
    assert loss.shape == () and torch.isfinite(loss)
    assert (float(metrics["aux"]) > 0) == bool(cfg.n_experts)


MOE_ARCHS = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mla_loss_and_grads_match_reference(arch):
    """The MoE and MLA families' loss (cross-entropy plus MOE_AUX_WEIGHT
    times the load-balance loss) and step 0's gradients against
    ``jax.value_and_grad`` of the reference's, at the smoke config in
    float32 (parameters too: bf16 gradients would round the comparison),
    at the dense case's limits; ``aux`` at 1e-5 relative."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               dtype="float32", param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              param_dtype="float32")
    params = numpy_params(jcfg)
    b = JSyntheticLM(jcfg, batch=2, seq=24, seed=3).batch_at(0)
    batch = {k: v[0] for k, v in b.items()}
    (want, jm), want_g = jax.value_and_grad(
        j_make_loss_fn(jcfg), has_aux=True)(params, batch)
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(cfg, params, "cpu").items()}
    loss, metrics = make_loss_fn(cfg)(
        leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert float(jm["aux"]) > 0
    assert _rel(metrics["aux"].detach(), jm["aux"]) <= 1e-5
    assert _rel(loss.detach(), want) <= 1e-5
    assert _rel(metrics["ce"].detach(), jm["ce"]) <= 1e-5
    for k, g in grads.items():
        wg = np.asarray(want_g[k])
        assert np.abs(g.numpy() - wg).max() <= 1e-4 * np.abs(wg).max(), k


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_trainer_fused_mode_moe(arch):
    """The MoE and MLA families train in the Trainer's fused mode (AdamW
    on the device): finite losses that fall on a fixed batch."""
    cfg = get_config(arch, smoke=True)
    opt = AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    tr = Trainer(cfg, opt, TrainConfig(steps=4, log_every=0), device="cpu")
    tr.run(FixedBatch(_fixed_batch(cfg)))
    losses = [m["loss"] for m in tr.metrics_log]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    tr.close()


def test_trainer_offload_mode_moe(tmp_path):
    """An OFFLOAD_ARCHS configuration (deepseek-v2-236b, MLA and MoE, bf16
    parameters) trains in offload mode: AdamW's state in a storage
    window, the bf16 parameters the window's masters after the sync."""
    from repro_torch.configs import OFFLOAD_ARCHS
    arch = "deepseek-v2-236b"
    assert arch in OFFLOAD_ARCHS
    cfg = get_config(arch, smoke=True)
    opt = AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    tc = TrainConfig(steps=4, mode="offload", log_every=0,
                     ckpt_dir=str(tmp_path / "oo"), ckpt_every=4)
    tr = Trainer(cfg, opt, tc, device="cpu")
    p, o = tr.run(FixedBatch(_fixed_batch(cfg)))
    losses = [m["loss"] for m in tr.metrics_log]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert o is None and all(v.dtype == torch.bfloat16 for k, v in p.items()
                             if not k.endswith("router"))
    assert os.path.exists(tmp_path / "oo" / "optstate.bin")
    masters = tr.offload_opt.masters()
    for k, v in p.items():
        assert torch.equal(torch.from_numpy(masters[k]).to(v.dtype), v), k
    tr.close()


# -- AdamW, compression, fault hooks -------------------------------------------

def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (32, 16), "b": (16,), "g0/p0/norm1": (16,),
              "embed/tok": (50, 8)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("cfg", [
    dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1),
    dict(lr=1e-3, warmup_steps=0, total_steps=3, clip_norm=0.0),
], ids=["clip_decay", "noclip"])
def test_adamw_matches_reference(cfg):
    params, grads = _opt_inputs()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = j_init_opt_state(jp), init_opt_state(tp)
    assert int(ts["step"]) == 0 and ts["step"].dtype == torch.int32
    assert all(float(v.abs().sum()) == 0 for v in ts["m"].values())
    jc, tc = JAdamWConfig(**cfg), AdamWConfig(**cfg)
    for g in grads:
        assert _rel(global_norm({k: torch.from_numpy(v) for k, v in g.items()}),
                    j_global_norm({k: jnp.asarray(v) for k, v in g.items()})) \
            <= 1e-6
        jp, js, jstats = j_adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jc)
        tp, ts, tstats = adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tc)
        assert abs(float(tstats["lr"]) - float(jstats["lr"])) <= LR_TOL * tc.lr
        assert int(ts["step"]) == int(js["step"])
        for k in params:
            for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]),
                              (ts["v"][k], js["v"][k])):
                want = np.asarray(want)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())


def test_global_norm_does_not_depend_on_dict_order():
    """The squares are summed in sorted key order, as in the reference's
    jitted step (which flattens the dict by key), so a tree built in
    another order (a restored one) gives the same bits: here insertion
    order b..i, a would sum the squares to 2^24 + 8 (a norm of 4096 +
    2^-10) where sorted order rounds each step back to 2^24."""
    vals = {"a": [4096.0], **{k: [1.0] for k in "bcdefghi"}}
    orders = (sorted(vals), [*"bcdefghi", "a"], [*"bcd", "a", *"efghi"])
    norms = [global_norm({k: torch.tensor(vals[k]) for k in order})
             for order in orders]
    want = jax.jit(j_global_norm)({k: jnp.asarray(vals[k]) for k in
                                   orders[1]})
    for n in norms:
        assert n.numpy().tobytes() == np.asarray(want).tobytes()
    assert float(norms[0]) == 4096.0


def test_compress_with_feedback_bit_equal():
    rng = np.random.default_rng(4)
    g = {"w": rng.standard_normal((40, 7)).astype(np.float32),
         "z": np.zeros(5, np.float32),
         "h": (np.arange(-6, 7, dtype=np.float32) / 12)}  # halves: ties
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jef, tef = jcompress.init_error_feedback(jg), compress.init_error_feedback(tg)
    for _ in range(3):
        jh, jef = jcompress.compress_with_feedback(jg, jef)
        th, tef = compress.compress_with_feedback(tg, tef)
        for k in g:
            assert th[k].numpy().tobytes() == np.asarray(jh[k]).tobytes()
            assert tef[k].numpy().tobytes() == np.asarray(jef[k]).tobytes()
    q, s = compress.quantize_int8(tg["w"], axis=0)
    jq, js = jcompress.quantize_int8(jg["w"], axis=0)
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert s.numpy().tobytes() == np.asarray(js).tobytes()


def test_fault_hooks_equal_reference():
    for mod in (jfault, fault):
        hb = mod.HeartbeatMonitor(4, timeout=10, dead_timeout=50)
        for r in range(4):
            hb.beat(r, step=1, now=100.0)
        hb.beat(0, step=2, now=130.0)
        hb.mark_dead(3)
        sd = mod.StragglerDetector(8, k=3.0, persist=2)
        for _ in range(4):
            for r in range(8):
                sd.record(r, 1.0 if r != 5 else 3.0)
            out = sd.stragglers()
        alive = [r for r in range(512) if r not in range(16, 40)]
        plans = [mod.plan_recovery(512, a, model=16, pods=2)
                 for a in (range(512), alive,
                           list(range(256, 512)) + list(range(8)))]
        got = (hb.suspects(now=131.0), hb.dead(now=131.0),
               hb.dead(now=160.0), hb.alive(now=160.0), out,
               [dataclasses.astuple(p) for p in plans])
        if mod is jfault:
            want = got
    assert got == want
    assert got[4] == [5] and got[1] == [3]


def test_failure_detector_equals_reference():
    seen = []
    for core, det, mon in ((JComm, JFailureDetector, jfault.HeartbeatMonitor),
                           (Communicator, FailureDetector,
                            fault.HeartbeatMonitor)):
        comm = core(3)
        hb = mon(3)
        fd = det(comm, hb)
        r = [fd.poll(0), hb.dead()]
        comm.mark_dead(2)
        r += [fd.poll(1), hb.dead(), comm.probe(2), comm.probe(1)]
        comm.mark_alive(2)
        r += [fd.poll(2), sorted(comm.dead_ranks), hb.dead()]
        seen.append(r)
        comm.close()
    assert seen[0] == seen[1]
    assert seen[1][2] == [2]
    # a world with no windows rebuilds nothing, as the reference's
    for core in (JComm, Communicator):
        comm = core(2)
        comm.mark_dead(1)
        assert comm.rebuild_rank(1) == 0 and 1 not in comm.dead_ranks
        comm.close()


# -- the Trainer ------------------------------------------------------------------

def _trainer_run(pkg, dtype, mb=2):
    jcfg, cfg = configs(dtype)
    params = numpy_params(jcfg, seed=2)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    tc = dict(steps=STEPS, microbatches=mb, log_every=0)
    ds = JSyntheticLM(jcfg, batch=2, seq=24, microbatches=mb, seed=4)
    data = (ds.batch_at(i) for i in range(STEPS))
    if pkg == "ref":
        tr = JTrainer(jcfg, JAdamWConfig(**opt), JTrainConfig(**tc))
        p, _ = tr.run(data, params={k: jnp.asarray(v)
                                    for k, v in params.items()})
        p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    else:
        tr = Trainer(cfg, AdamWConfig(**opt), TrainConfig(**tc), device="cpu")
        p, _ = tr.run(data, params=params_from_numpy(cfg, params, "cpu"))
        p = {k: v.float().numpy() for k, v in p.items()}
    tr.close()
    return [m["loss"] for m in tr.metrics_log], p, opt["lr"]


@pytest.fixture(scope="module")
def ref_float32():
    return _trainer_run("ref", "float32")


def test_trainer_matches_reference_float32(ref_float32):
    want_l, want_p, lr = ref_float32
    got_l, got_p, _ = _trainer_run("port", "float32")
    assert len(got_l) == STEPS
    for g, w in zip(got_l, want_l):
        assert _rel(g, w) <= 1e-4, (got_l, want_l)
    n_out = n = 0
    for k, w in want_p.items():
        d = np.abs(got_p[k] - w)
        assert d.max() <= 2 * lr * STEPS, k
        n_out += int((d > 1e-5 + 1e-4 * np.abs(w)).sum())
        n += w.size
    assert n_out <= 1e-3 * n, (n_out, n)


def test_trainer_bf16_losses_match_reference():
    want, _, _ = _trainer_run("ref", "bfloat16", mb=1)
    got, _, _ = _trainer_run("port", "bfloat16", mb=1)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 2e-2, (got, want)


# -- the reference's Trainer tests, on the port --------------------------------

class FixedBatch:
    """Repeats one batch -> loss must fall (overfit sanity)."""

    def __init__(self, batch):
        self.batch = batch

    def __next__(self):
        return self.batch


def _fixed_batch(cfg, mb=1, B=4, S=24):
    return SyntheticLM(cfg, batch=B, seq=S, microbatches=mb,
                       seed=7).batch_at(0)


def _smoke():
    return get_config(ARCH, smoke=True)


def test_trainer_overfits_fixed_batch():
    cfg = _smoke()
    opt = AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    tr = Trainer(cfg, opt, TrainConfig(steps=25, log_every=0), device="cpu")
    tr.run(FixedBatch(_fixed_batch(cfg)))
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0] - 1.0, losses[::6]
    tr.close()


class Stream:
    """SyntheticLM's batches from ``start`` on."""

    def __init__(self, cfg, start=0):
        self.ds = SyntheticLM(cfg, batch=2, seq=16, seed=1)
        self.step = start

    def __next__(self):
        b = self.ds.batch_at(self.step)
        self.step += 1
        return b


@pytest.mark.parametrize("ckpt_async", [False, True])
def test_trainer_ckpt_restart_is_exact(tmp_path, ckpt_async):
    """Kill after step 4; the restart continues to the same bits."""
    cfg = _smoke()
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100)
    trA = Trainer(cfg, opt, TrainConfig(steps=8, log_every=0), device="cpu")
    pA, oA = trA.run(Stream(cfg))
    tcB = TrainConfig(steps=8, log_every=0, ckpt_dir=str(tmp_path / "ck"),
                      ckpt_every=2, ckpt_async=ckpt_async)
    trB = Trainer(cfg, opt, tcB, device="cpu")
    trB.run(Stream(cfg), stop_after=4)
    trB.close()  # "crash" after the pending save is committed
    trC = Trainer(cfg, opt, tcB, device="cpu")
    pC, oC = trC.run(Stream(cfg, start=4))
    assert trC.restored_step == 4
    assert [m["loss"] for m in trC.metrics_log] == \
        [m["loss"] for m in trA.metrics_log[4:]]
    for k in pA:
        assert torch.equal(pA[k], pC[k]), k
        assert torch.equal(oA["m"][k], oC["m"][k]), k
        assert torch.equal(oA["v"][k], oC["v"][k]), k
    assert torch.equal(oA["step"], oC["step"])
    trA.close()
    trC.close()


def test_trainer_offload_mode(tmp_path):
    cfg = _smoke()
    opt = AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    tc = TrainConfig(steps=10, mode="offload", log_every=0,
                     ckpt_dir=str(tmp_path / "oo"), ckpt_every=5)
    tr = Trainer(cfg, opt, tc, device="cpu")
    p, o = tr.run(FixedBatch(_fixed_batch(cfg)))
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0]
    assert o is None and all(v.dtype == torch.bfloat16 for v in p.values())
    # optimizer state lives in window files on storage
    assert os.path.exists(tmp_path / "oo" / "optstate.bin")
    # after the sync at step 10, the window holds the masters that the
    # last update returned, and the params are them in bf16
    masters = tr.offload_opt.masters()
    for k, v in p.items():
        assert torch.equal(torch.from_numpy(masters[k]).to(torch.bfloat16), v)
    tr.close()


def test_trainer_compression_still_learns():
    cfg = _smoke()
    opt = AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    tr = Trainer(cfg, opt, TrainConfig(steps=20, compression=True,
                                       log_every=0), device="cpu")
    tr.run(FixedBatch(_fixed_batch(cfg)))
    losses = [m["loss"] for m in tr.metrics_log]
    assert losses[-1] < losses[0] - 0.5
    tr.close()


def test_train_e2e_kill_and_restart_on_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_e2e", "--device",
         "cpu", "--steps", "8", "--ckpt-every", "2", "--kill-at", "5",
         "--seq", "16", "--ckpt-dir", str(tmp_path / "e2e")],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed at step 4, finished at 8" in r.stdout
    assert "bit-identical" in r.stdout, r.stdout


def test_train_e2e_needs_a_fresh_checkpoint(tmp_path):
    """The --kill-at comparison is refused where it would compare nothing:
    a directory that holds a checkpoint already (its restore would skip
    phase 1), or a kill at a checkpoint step (the restart repeats no
    step)."""
    from repro_torch.launch import train_e2e
    (tmp_path / "manifest.json").write_text("{}")
    args = ["--device", "cpu", "--steps", "8", "--ckpt-every", "2", "--seq",
            "16"]
    assert train_e2e.main(args + ["--kill-at", "5", "--ckpt-dir",
                                  str(tmp_path)]) == 2
    assert train_e2e.main(args + ["--kill-at", "4"]) == 2


def test_train_e2e_default_directory_is_fresh_and_removed(tmp_path,
                                                          monkeypatch):
    """Without --ckpt-dir each run makes its own directory under the temp
    dir and removes it, and leaves deterministic algorithms as it found
    them."""
    from repro_torch.launch import train_e2e
    monkeypatch.setattr(train_e2e.tempfile, "tempdir", str(tmp_path))
    args = ["--device", "cpu", "--steps", "4", "--ckpt-every", "2", "--seq",
            "16"]
    assert train_e2e.main(args + ["--kill-at", "3"]) == 0
    assert train_e2e.main(args + ["--kill-at", "3"]) == 0
    assert not [p for p in tmp_path.iterdir()
                if p.name.startswith("repro_torch_train_e2e_")]
    assert not torch.are_deterministic_algorithms_enabled()


def test_chip_smoke_training_routine_on_cpu(tmp_path):
    """``chip_smoke.py`` phase 6's routine at smoke widths on the CPU: runs
    A, B (checkpointed, stopped), the restore and C (bit-equal to A, checked
    inside), each save's file and flushed bytes, and the offload run."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    cfg = dataclasses.replace(_smoke(), remat="full")
    out = chip_smoke.run_training(cfg, device="cpu", directory=tmp_path,
                                  seq=32, log=lambda *a: None)
    steps = chip_smoke.TRAIN_PHASES["6"]["steps"]
    assert len(out["losses"]) == steps and len(out["step_ms"]) == steps - 1
    assert [r["step"] for r in out["saves"]] == [2, 4, 6]
    assert [r["target"] for r in out["saves"]] == ["a", "b", "a"]
    assert len(out["offload_losses"]) == chip_smoke.TRAIN["offload_steps"]
    assert not torch.are_deterministic_algorithms_enabled()
