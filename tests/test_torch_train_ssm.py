"""The port's training path through Mamba-2 and RecurrentGemma blocks
against the JAX package's.

Same numpy inputs (parameters from the reference's ``init_params`` with
the published dynamics, ``chip_smoke.ssm_dynamics`` and
``chip_smoke.rglru_dynamics``, under which the recurrences carry state
across the sequence; batches from ``SyntheticLM``) go through both
packages; the port gets CPU tensors.  The model-level tests are
parametrised over mamba2-2.7b and recurrentgemma-2b at smoke widths.
Limits:

* a block's training forward (``mamba2_forward`` / ``griffin_forward``
  with ``train=True``): values, input and parameter gradients at 1e-5 of
  each tensor's largest |value| in float32, 2e-2 in bf16.
* ``linear_scan`` against ``jax.lax.associative_scan`` with the
  reference's ``combine`` and against the plain sequential recurrence:
  values and gradients at 1e-5.
* ``blockwise_attention`` with the window binding: 2e-5
  (``tests/test_torch_train.py``'s attention limit).
* ``make_loss_fn``, ``Trainer``: the limits of ``tests/test_torch_train.py``
  (loss 1e-5 relative, gradients 1e-4 of each leaf's largest |g|; the
  float32 Trainer's losses at 1e-4 and parameters within 2·lr per step,
  all but 0.1% within 1e-5 + 1e-4·|p|; bf16 losses at 2e-2); remat
  ``none``, ``full`` and ``dots`` give the port the same bits, and a
  restored run the same bits as an uninterrupted one.

The training path must reach no kernel of ``repro_torch.kernels.ops``:
on the CPU those wrappers run plain versions that autograd would
differentiate, while on the card they launch kernels with no backward.
"""

import dataclasses
import functools
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import griffin as jgriffin
from repro.models import init_params as j_init_params
from repro.models import make_loss_fn as j_make_loss_fn
from repro.models import param_specs as j_param_specs
from repro.models import ssm as jssm
from repro.models.attention import blockwise_attention as j_blockwise
from repro.models.lm import _cast_params as j_cast_params
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops, ref
from repro_torch.models import (cast_params, griffin, make_loss_fn,
                                param_specs, ssm)
from repro_torch.models.attention import blockwise_attention
from repro_torch.train import AdamWConfig, TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["mamba2-2.7b", "recurrentgemma-2b"]
STEPS = 4


@functools.cache
def _chip_smoke():
    """``chip_smoke.py`` (the repo root's script) as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def configs(arch, dtype="float32", **kw):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                                **kw))


@functools.cache
def _numpy_params(arch, seed):
    jcfg, cfg = configs(arch)
    out = {k: np.asarray(v) for k, v in j_init_params(
        j_param_specs(jcfg), jax.random.PRNGKey(seed)).items()}
    cs = _chip_smoke()
    out.update(cs.ssm_dynamics(cfg, seed))
    out.update(cs.rglru_dynamics(cfg, seed))
    return out


def numpy_params(arch, seed=1):
    """The reference's init with the published dynamics (a fresh copy)."""
    return {k: v.copy() for k, v in _numpy_params(arch, seed).items()}


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def close(got, want, tol):
    """Within ``tol`` of the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, \
        float(np.abs(got - want).max()) / scale


# -- a block's training forward ------------------------------------------------

def _block_case(arch):
    """The first layer's parameters and the block function of each package."""
    jcfg, cfg = configs(arch)
    params = numpy_params(arch)
    pj = 0  # mamba2: the ssm block; recurrentgemma: the first rglru block
    layer = {k.split("/")[-1]: v[0] for k, v in params.items()
             if k.startswith(f"g0/p{pj}/")}
    if arch.startswith("mamba2"):
        names = ["in_proj", "conv_w", "A_log", "D", "dt_bias", "norm",
                 "out_proj"]
        return layer, names, jssm.mamba2_forward, ssm.mamba2_forward
    names = ["wx", "wy", "conv_w", "w_i", "b_i", "w_r", "b_r", "lam", "wo"]
    return layer, names, jgriffin.griffin_forward, griffin.griffin_forward


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_train_forward_matches_reference(arch, dtype, tol):
    """The block's training forward (the chunked SSD scan, or the RG-LRU
    through ``linear_scan``) with its output, input and parameter
    gradients.  Parameters and input are float32 leaves cast inside, as
    the loss casts them, so the gradients come back in float32."""
    jcfg, cfg = configs(arch, dtype)
    layer, names, j_fwd, fwd = _block_case(arch)
    layer = {k: layer[k] for k in names}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def j_obj(p, x):
        out = j_fwd(jcfg, j_cast_params(jcfg, p), x.astype(jdt))
        return (out.astype(jnp.float32) * w).sum(), out

    (_, want), (want_gp, want_gx) = jax.value_and_grad(
        j_obj, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in layer.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = fwd(cfg, cast_params(cfg, tp), tx.to(getattr(torch, dtype)),
              train=True)
    assert out.dtype == getattr(torch, dtype)
    grads = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                                [tx, *tp.values()])
    close(out.detach().float().numpy(), np.asarray(want, np.float32), tol)
    close(grads[0].numpy(), want_gx, tol)
    for k, g in zip(tp, grads[1:]):
        assert g.dtype == torch.float32, k
        close(g.numpy(), want_gp[k], tol)


# -- the RG-LRU scan -------------------------------------------------------------

def _combine(l, r):
    """The reference's ``combine`` (``src/repro/models/griffin.py``)."""
    return l[0] * r[0], l[1] * r[0] + r[1]


@pytest.mark.parametrize("S", [1, 7, 40, 257])
def test_linear_scan_matches_associative_scan(S):
    """``linear_scan`` against ``jax.lax.associative_scan`` and against the
    plain sequential recurrence (``ref.rg_lru_ref``), values and the
    gradients of both inputs, with a in Griffin's published range (the
    state carries over hundreds of positions)."""
    rng = np.random.default_rng(S)
    u = rng.uniform(*_chip_smoke().RG_A_RANGE, (1, 1, 24))
    a = (u ** rng.uniform(0, 1, (2, S, 24))).astype(np.float32)
    b = rng.standard_normal((2, S, 24)).astype(np.float32)
    w = rng.standard_normal((2, S, 24)).astype(np.float32)

    def j_obj(a, b):
        h = jax.lax.associative_scan(_combine, (a, b), axis=1)[1]
        return (h * w).sum(), h

    (_, want), want_g = jax.value_and_grad(j_obj, argnums=(0, 1),
                                           has_aux=True)(a, b)
    for scan in (griffin.linear_scan, ref.rg_lru_ref):
        ta, tb = (torch.from_numpy(v).requires_grad_(True) for v in (a, b))
        h = scan(ta, tb)
        # at S 1 h is b: a's gradient is 0, as JAX gives it
        g = torch.autograd.grad((h * torch.from_numpy(w)).sum(), (ta, tb),
                                materialize_grads=True)
        close(h.detach().numpy(), want, 1e-5)
        for got, wg in zip(g, want_g):
            close(got.numpy(), wg, 1e-5)
    seq = ref.rg_lru_ref(torch.from_numpy(a), torch.from_numpy(b))
    close(griffin.linear_scan(torch.from_numpy(a), torch.from_numpy(b)),
          seq.numpy(), 1e-5)


@pytest.mark.parametrize("S", [1, 40])
def test_rg_lru_train_with_h0_matches_reference(S):
    """``rg_lru(train=True)`` with a carried state folded into the first
    step (out of place) against the reference's ``rg_lru``, with the
    gradients of the input and of the state, on recurrentgemma-2b's first
    layer."""
    _, cfg = configs("recurrentgemma-2b")
    layer = _block_case("recurrentgemma-2b")[0]
    p = {k: layer[k] for k in ("w_i", "b_i", "w_r", "b_r", "lam")}
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.lru)).astype(np.float32)
    h0 = rng.standard_normal((2, cfg.lru)).astype(np.float32)
    w = rng.standard_normal((2, S, cfg.lru)).astype(np.float32)

    def j_obj(x, h0):
        y, h = jgriffin.rg_lru(p, x, h0)
        return (y * w).sum() + h.sum(), y

    (_, want), want_g = jax.value_and_grad(j_obj, argnums=(0, 1),
                                           has_aux=True)(x, h0)
    tx, th = (torch.from_numpy(v).requires_grad_(True) for v in (x, h0))
    y, h = griffin.rg_lru({k: torch.from_numpy(v) for k, v in p.items()},
                          tx, th, train=True)
    g = torch.autograd.grad((y * torch.from_numpy(w)).sum() + h.sum(),
                            (tx, th))
    close(y.detach().numpy(), want, 1e-5)
    for got, wg in zip(g, want_g):
        close(got.numpy(), wg, 1e-5)


# -- the windowed training attention -----------------------------------------------

@pytest.mark.parametrize("blocks", [dict(), dict(q_block=16, kv_block=16)],
                         ids=["one_block", "blocks_16"])
def test_blockwise_attention_window_binds(blocks):
    """recurrentgemma-2b's ``local_attn`` at smoke widths (H 4, K 1, d 16)
    with its window of 32 binding at S 40, forward and gradients; with
    16-position blocks whole kv blocks fall outside the window."""
    cfg = get_config("recurrentgemma-2b", smoke=True)
    assert cfg.window == 32
    rng = np.random.default_rng(40)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 40, 4, 16), (2, 40, 1, 16), (2, 40, 1, 16)))
    w = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    kw = dict(causal=True, window=cfg.window, **blocks)

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
    # the window binds: the last query's output differs from full causal
    full = blockwise_attention(tq, tk, tv, causal=True)
    assert not torch.allclose(full[:, -1], out[:, -1])


# -- the loss -------------------------------------------------------------------

@functools.cache
def _loss_case(arch):
    jcfg, _ = configs(arch)
    params = numpy_params(arch)
    b = JSyntheticLM(jcfg, batch=2, seq=40, seed=3).batch_at(0)
    batch = {k: v[0] for k, v in b.items()}
    batch["targets"][1, 5:9] = -1  # masked targets inside a row
    (loss, metrics), grads = jax.value_and_grad(
        j_make_loss_fn(jcfg), has_aux=True)(params, batch)
    return params, batch, float(loss), float(metrics["ntok"]), {
        k: np.asarray(v) for k, v in grads.items()}


def _port_loss(arch, remat, params, batch):
    _, cfg = configs(arch, remat=remat)
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(cfg, params, "cpu").items()}
    loss, metrics = make_loss_fn(cfg)(
        leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    params, batch, want, ntok, want_g = _loss_case(arch)
    loss, metrics, grads = _port_loss(arch, remat, params, batch)
    assert _rel(loss, want) <= 1e-5
    assert float(metrics["ntok"]) == ntok
    assert float(metrics["aux"]) == 0.0
    assert sorted(grads) == sorted(want_g)
    for k, g in grads.items():
        scale = np.abs(want_g[k]).max()
        assert np.abs(g.numpy() - want_g[k]).max() <= 1e-4 * scale, k


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_does_not_change_a_bit(arch):
    params, batch = _loss_case(arch)[:2]
    base_loss, _, base = _port_loss(arch, "none", params, batch)
    for remat in ("full", "dots"):
        loss, _, grads = _port_loss(arch, remat, params, batch)
        assert torch.equal(loss, base_loss), remat
        for k in base:
            assert torch.equal(grads[k], base[k]), (remat, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_calls_no_kernel_and_no_gradient_is_nan(arch, monkeypatch):
    """``Trainer.loss_and_grads`` in the bf16 config the card trains, with
    every model function of ``ops`` replaced by one that raises: the
    training path reaches none of them (on the card each launches a
    kernel with no backward).  Every gradient is finite."""
    def refuse(*a, **kw):
        raise AssertionError("the training path reached a kernel of ops")

    for name in ("flash_attention", "ssd_scan", "rg_lru_scan"):
        monkeypatch.setattr(ops, name, refuse)
    _, cfg = configs(arch, "bfloat16", remat="full")
    tr = Trainer(cfg, AdamWConfig(), TrainConfig(microbatches=2,
                                                 log_every=0), device="cpu")
    params = params_from_numpy(cfg, numpy_params(arch), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        cfg, batch=2, seq=40, microbatches=2, seed=6).batch_at(0).items()}
    loss, grads = tr.loss_and_grads(params, batch)
    assert math.isfinite(float(loss))
    assert sorted(grads) == sorted(params)
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
    tr.close()
    # the serving forward of the same block reaches them: the patch holds
    layer, _, _, fwd = _block_case(arch)
    x = torch.zeros((1, 8, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(AssertionError, match="reached a kernel"):
        fwd(cfg, cast_params(cfg, {k: torch.from_numpy(v)
                                   for k, v in layer.items()}), x)


# -- the Trainer ------------------------------------------------------------------

def _trainer_run(arch, pkg, dtype, mb=2):
    jcfg, cfg = configs(arch, dtype)
    params = numpy_params(arch, seed=2)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference_float32(arch):
    want_l, want_p, lr = _trainer_run(arch, "ref", "float32")
    got_l, got_p, _ = _trainer_run(arch, "port", "float32")
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


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_bf16_losses_match_reference(arch):
    want, _, _ = _trainer_run(arch, "ref", "bfloat16", mb=1)
    got, _, _ = _trainer_run(arch, "port", "bfloat16", mb=1)
    assert all(math.isfinite(x) for x in got)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 2e-2, (got, want)


class Stream:
    """SyntheticLM's batches from ``start`` on."""

    def __init__(self, cfg, start=0):
        self.ds = SyntheticLM(cfg, batch=2, seq=24, seed=1)
        self.step = start

    def __next__(self):
        b = self.ds.batch_at(self.step)
        self.step += 1
        return b


@pytest.mark.parametrize("ckpt_async", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_ckpt_restart_is_exact(tmp_path, arch, ckpt_async):
    """Kill after step 4; the restart continues to the same bits: params,
    moments (``A_log``, ``dt_bias``, ``D``, ``lam``, ``b_i``, ``b_r`` and
    the norms in float32 slots), step and losses."""
    _, cfg = configs(arch, "bfloat16", remat="full")
    params = numpy_params(arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=100)

    def start():
        return params_from_numpy(cfg, params, "cpu")

    trA = Trainer(cfg, opt, TrainConfig(steps=8, log_every=0), device="cpu")
    pA, oA = trA.run(Stream(cfg), start())
    tcB = TrainConfig(steps=8, log_every=0, ckpt_dir=str(tmp_path / "ck"),
                      ckpt_every=2, ckpt_async=ckpt_async)
    trB = Trainer(cfg, opt, tcB, device="cpu")
    trB.run(Stream(cfg), start(), stop_after=4)
    trB.close()  # "crash" after the pending save is committed
    trC = Trainer(cfg, opt, tcB, device="cpu")
    pC, oC = trC.run(Stream(cfg, start=4), start())
    assert trC.restored_step == 4
    assert [m["loss"] for m in trC.metrics_log] == \
        [m["loss"] for m in trA.metrics_log[4:]]
    assert all(math.isfinite(m["loss"]) for m in trA.metrics_log)
    for k in pA:
        assert pA[k].dtype == torch.float32, k
        assert torch.equal(pA[k], pC[k]), k
        assert torch.equal(oA["m"][k], oC["m"][k]), k
        assert torch.equal(oA["v"][k], oC["v"][k]), k
    assert torch.equal(oA["step"], oC["step"])
    trA.close()
    trC.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_offload_mode(tmp_path, arch):
    """Two offload-mode steps: bf16 params on the device, the optimizer
    state in a window file, which after the sync holds the masters that
    the last update returned."""
    _, cfg = configs(arch, "bfloat16")
    opt = AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=100)
    tc = TrainConfig(steps=2, mode="offload", log_every=0,
                     ckpt_dir=str(tmp_path / "oo"), ckpt_every=2)
    tr = Trainer(cfg, opt, tc, device="cpu")
    p, o = tr.run(Stream(cfg), params_from_numpy(cfg, numpy_params(arch),
                                                 "cpu"))
    assert o is None and all(v.dtype == torch.bfloat16 for v in p.values())
    assert all(math.isfinite(m["loss"]) for m in tr.metrics_log)
    path = tmp_path / "oo" / "optstate.bin"
    masters = tr.offload_opt.masters()
    slots = tr.offload_opt.state.slots
    assert sorted(masters) == sorted(p)
    assert _chip_smoke().window_equal(
        path, {k: slots[f"master/{k}"] for k in masters},
        {k: v.reshape(-1).view(np.uint8) for k, v in masters.items()})
    for k, v in p.items():
        assert torch.equal(torch.from_numpy(masters[k]).to(torch.bfloat16), v)
    tr.close()


# -- chip_smoke.py's phases 6b and 6c ----------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_training_routine_on_cpu(tmp_path, arch, monkeypatch):
    """``chip_smoke.py`` phase 6b's (mamba2-2.7b: runs A, B stopped after
    its checkpoints, the restore and C, bit-equal to A, checked inside;
    each save's file and flushed bytes) or 6c's routine (recurrentgemma-2b:
    run A only) at smoke widths, seq 32, with every model function of
    ``ops`` refusing: the routine launches no kernel."""
    def refuse(*a, **kw):
        raise AssertionError("the training path reached a kernel of ops")

    for name in ("flash_attention", "ssd_scan", "rg_lru_scan"):
        monkeypatch.setattr(ops, name, refuse)
    cs = _chip_smoke()
    phase = {"mamba2-2.7b": "6b", "recurrentgemma-2b": "6c"}[arch]
    spec = cs.TRAIN_PHASES[phase]
    assert spec["arch"] == arch and spec["offload"] is False
    full = cs.train_config(phase)
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat="full",
                              n_layers=full.n_layers)
    assert cfg.groups() == dataclasses.replace(
        get_config(arch), n_layers=full.n_layers).groups()
    out = cs.run_training(cfg, device="cpu", directory=tmp_path, seq=32,
                          phase=phase, log=lambda *a: None)
    steps, microbatches = spec["steps"], spec["microbatches"]
    assert len(out["losses"]) == steps and len(out["step_ms"]) == steps - 1
    assert out["tokens_per_step"] == 2 * microbatches * 32
    assert out["loss0_rel_err"] <= cs.TRAIN_F32_TOL
    assert "offload_losses" not in out
    if "B" in spec["runs"]:
        assert [r["step"] for r in out["saves"]] == [2, 4, 6]
        assert [r["target"] for r in out["saves"]] == ["a", "b", "a"]
    else:
        assert "saves" not in out and not list(tmp_path.iterdir())
    assert not torch.are_deterministic_algorithms_enabled()


def test_chip_smoke_training_phases_sizes():
    """6b and 6c at full widths: the parameter counts and windows the
    phases are sized by (params, m and v in float32), and the window
    binding at TRAIN's sequence length."""
    cs = _chip_smoke()
    counts = {}
    for phase in ("6b", "6c"):
        cfg = cs.train_config(phase)
        counts[phase] = sum(int(np.prod(s.shape))
                            for s in param_specs(cfg).values())
    assert counts == {"6b": 209_141_728, "6c": 912_314_880}
    assert cs.train_config("6c").groups() == [
        (1, ("rglru", "rglru", "local_attn"))]
    assert cs.train_config("6c").window < 4096 == \
        SHAPES[cs.TRAIN["shape"]].seq
