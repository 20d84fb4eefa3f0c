"""The port's Mamba-2 model against the JAX package's, on the same numpy inputs.

Parameters are made by the reference's ``init_params`` and handed to the
port through ``convert.params_from_numpy``; ``A_log`` and ``dt_bias`` are
then set in Mamba-2's published ranges (``chip_smoke.ssm_dynamics``), under
which the state carries across many positions (the reference's zeros make
it forget within a few).  Layers are held at 1e-5 in float32; prefill and
decode logits at 1e-4 relative in a ``dtype="float32"`` config and 2e-2 in
bf16, where the reference's ``ssd_chunked`` rounds ``xdt`` and the scores
to bf16 and the port's scan (its plain version here) does not.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_cache_specs as j_cache_specs
from repro.models import init_params as j_init_params
from repro.models import layers as jlayers
from repro.models import make_decode_fn as j_decode_fn
from repro.models import make_prefill_fn as j_prefill_fn
from repro.models import param_specs as j_param_specs
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, to_host_f32
from repro_torch.models import (cast_params, init_cache_specs, make_decode_fn,
                                make_prefill_fn, param_specs)
from repro_torch.models import layers, ssm
from repro_torch.serve import Engine

ARCH = "mamba2-2.7b"
ROOT = Path(__file__).resolve().parents[1]
B = 2


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def configs(dtype="bfloat16"):
    return (dataclasses.replace(j_get_config(ARCH, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype))


def numpy_params(chip_smoke, jcfg, seed=1):
    """The reference's init with the published SSM dynamics."""
    out = {k: np.asarray(v) for k, v in j_init_params(
        j_param_specs(jcfg), jax.random.PRNGKey(seed)).items()}
    _, cfg = configs()
    out.update(chip_smoke.ssm_dynamics(cfg, seed))
    return out


def prompt(vocab, n, seed=2):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, n)).astype(np.int32)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1e-6, np.abs(b).max()))


def test_mamba2_config_matches_reference():
    """The full config and its smoke reduction, field for field; 2.70 B
    parameters by ``param_specs`` in both packages."""
    for smoke in (True, False):
        want = dataclasses.asdict(j_get_config(ARCH, smoke=smoke))
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == want
    count = sum(int(np.prod(s.shape))
                for s in param_specs(get_config(ARCH)).values())
    assert count == 2_702_235_136 == sum(
        int(np.prod(s.shape))
        for s in j_param_specs(j_get_config(ARCH)).values())


def test_mamba2_specs_match_reference():
    """``param_specs`` and ``init_cache_specs``: names, shapes, dtypes,
    logical axes and init kinds."""
    for smoke in (True, False):
        jcfg, cfg = j_get_config(ARCH, smoke=smoke), get_config(ARCH,
                                                               smoke=smoke)
        want, got = j_param_specs(jcfg), param_specs(cfg)
        assert sorted(got) == sorted(want)
        for k, s in got.items():
            r = want[k]
            assert (s.shape, s.dtype, s.axes, s.init) == \
                (r.shape, jnp.dtype(r.dtype).name, r.axes, r.init), k
        for batch, T in ((2, 32), (3, 5)):
            jc, tc = j_cache_specs(jcfg, batch, T), init_cache_specs(cfg, batch,
                                                                     T)
            assert sorted(tc) == sorted(jc) == ["g0/p0/conv", "g0/p0/h"]
            for k, s in tc.items():
                assert (s.shape, s.dtype, s.axes) == \
                    (jc[k].shape, jnp.dtype(jc[k].dtype).name, jc[k].axes), k
    full = init_cache_specs(get_config(ARCH), 4, 4096)
    assert full["g0/p0/h"].shape == (64, 4, 80, 128, 64)
    assert full["g0/p0/conv"].shape == (64, 4, 3, 5376)


def test_params_from_numpy_takes_the_mamba2_tree(chip_smoke):
    jcfg, cfg = configs()
    params = numpy_params(chip_smoke, jcfg)
    tp = params_from_numpy(cfg, params, device="cpu")
    assert sorted(tp) == sorted(param_specs(cfg))
    assert all(torch.equal(tp[k], t(v)) for k, v in params.items())
    bad = dict(params, **{"g0/p0/A_log": params["g0/p0/A_log"][:, :3]})
    with pytest.raises(ValueError, match="A_log"):
        params_from_numpy(cfg, bad, device="cpu")


@pytest.mark.parametrize("S", [1, 2, 7])
def test_causal_conv1d_matches_reference(S):
    """With and without a carried state, S below, at and above K-1 = 3:
    y at 1e-5 in float32, the new state equal."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.5).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        jy, js = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                       None if state is None
                                       else jnp.asarray(state))
        ty, ts = layers.causal_conv1d(t(x), t(w),
                                      None if state is None else t(state))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        assert ts.shape == (2, 3, 12)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    bf, bs = layers.causal_conv1d(t(x).to(torch.bfloat16), t(w))
    assert bf.dtype == bs.dtype == torch.bfloat16


def test_mamba2_layer_matches_reference(chip_smoke):
    """``mamba2_forward`` (the scan through ``ops.ssd_scan``) with its
    returned state and conv carry, then ``mamba2_decode_step`` from them,
    at 1e-5 in float32, with the same numpy parameters."""
    jcfg, cfg = configs("float32")
    params = numpy_params(chip_smoke, jcfg)
    p = {k.split("/")[-1]: v[0] for k, v in params.items()
         if k.startswith("g0/p0/")}
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, 21, cfg.d_model)) * 0.5).astype(np.float32)
    x1 = (rng.standard_normal((B, 1, cfg.d_model)) * 0.5).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    jo, (jh, jc) = jssm.mamba2_forward(jcfg, jp, jnp.asarray(x),
                                       return_state=True)
    to, (th, tc) = ssm.mamba2_forward(cfg, tp, t(x), return_state=True)
    for got, want in ((to, jo), (th, jh), (tc, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    jd, jh2, jc2 = jssm.mamba2_decode_step(jcfg, jp, jnp.asarray(x1), jh, jc)
    td, th2, tc2 = ssm.mamba2_decode_step(cfg, tp, t(x1), th, tc)
    for got, want in ((td, jd), (th2, jh2), (tc2, jc2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def _both_prefill_decode(chip_smoke, dtype, S, steps=3):
    jcfg, cfg = configs(dtype)
    params = numpy_params(chip_smoke, jcfg)
    toks = prompt(cfg.vocab, S + steps)
    T = S + steps + 1
    jcache = {k: jnp.zeros(v.shape, jnp.dtype(v.dtype))
              for k, v in j_cache_specs(jcfg, B, T).items()}
    jl, jcache = j_prefill_fn(jcfg)(params, {"inputs": jnp.asarray(toks[:, :S])},
                                    jcache)
    jout = [np.asarray(jl, np.float32)]
    jdec = j_decode_fn(jcfg)
    for i in range(steps):
        jl, jcache = jdec(params, jcache, jnp.asarray(toks[:, S + i:S + i + 1]),
                          jnp.int32(S + i))
        jout.append(np.asarray(jl, np.float32))
    tp = cast_params(cfg, params_from_numpy(cfg, params, device="cpu"))
    cache = {k: torch.zeros(v.shape, dtype=getattr(torch, v.dtype))
             for k, v in init_cache_specs(cfg, B, T).items()}
    tl, cache = make_prefill_fn(cfg)(tp, {"inputs": t(toks[:, :S]).long()},
                                     cache)
    tout = [to_host_f32(tl)]
    dec = make_decode_fn(cfg)
    for i in range(steps):
        tl, cache = dec(tp, cache, t(toks[:, S + i:S + i + 1]).long(), S + i)
        tout.append(to_host_f32(tl))
    return jout, tout


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_mamba2_prefill_decode_logits_match_reference(chip_smoke, dtype, tol):
    """S = 37 (more than two of the smoke config's 16-position chunks,
    ragged), then three decode steps."""
    jout, tout = _both_prefill_decode(chip_smoke, dtype, 37)
    for i, (a, b) in enumerate(zip(tout, jout)):
        assert a.shape == b.shape == (B, 1, 512)
        assert rel_err(a, b) < tol, (i, rel_err(a, b))


def test_mamba2_prefill_decode_consistent(chip_smoke):
    """decode(prefill(S), token_S) == prefill(S+1)'s last logits in the bf16
    smoke config, at the limit of tests/test_models.py (0.02)."""
    jcfg, cfg = configs()
    params = params_from_numpy(cfg, numpy_params(chip_smoke, jcfg),
                               device="cpu")
    toks = prompt(cfg.vocab, 18)
    err = chip_smoke.consistency_rel_err(
        cfg, Engine(cfg, params, batch=B, max_len=18, device="cpu"), toks)
    assert err < 0.02, err


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b"])
def test_float32_consistency_gate(chip_smoke, arch):
    """``chip_smoke.float32_consistency`` (phase 3's and phase 4's gate) on
    the smoke configs: far inside 1e-4 with a float32 cache.  With the
    specs' bf16 cache (bf16 even in a float32 config, as in the reference)
    the rounding of the cache alone crosses 1e-4: hence the float32 cache.
    And the gate can fail: a cache that the prefill did not fill (zeroed
    before the decode) reads far above it."""
    cfg = get_config(arch, smoke=True)
    params = chip_smoke.model_params(cfg, 0, "cpu")
    toks = prompt(cfg.vocab, 18, seed=4)
    err = chip_smoke.float32_consistency(cfg, params, toks, device="cpu")
    assert err < chip_smoke.F32_LIMIT / 10, err

    f32 = dataclasses.replace(cfg, dtype="float32")
    eng = Engine(f32, params, batch=B, max_len=18, device="cpu")
    assert chip_smoke.consistency_rel_err(f32, eng, toks) > \
        chip_smoke.F32_LIMIT
    eng.cache = {k: v.float() for k, v in eng.cache.items()}
    prefill = eng.prefill

    def prefill_then_forget(inputs):
        out = prefill(inputs)
        for v in eng.cache.values():
            v.zero_()
        return out
    eng.prefill = prefill_then_forget
    assert chip_smoke.consistency_rel_err(f32, eng, toks) > 10 * \
        chip_smoke.F32_LIMIT


def test_ssm_dynamics_are_the_published_ranges(chip_smoke):
    cfg = get_config(ARCH)
    dyn = chip_smoke.ssm_dynamics(cfg, 0)
    assert sorted(dyn) == ["g0/p0/A_log", "g0/p0/dt_bias"]
    dt = np.log1p(np.exp(dyn["g0/p0/dt_bias"].astype(np.float64)))
    assert dyn["g0/p0/dt_bias"].shape == (64, 80)
    assert 1e-3 <= dt.min() and dt.max() <= 1e-1 * (1 + 1e-6)
    A = np.exp(dyn["g0/p0/A_log"].astype(np.float64))
    assert 1 <= A.min() and A.max() <= 16
    assert chip_smoke.ssm_dynamics(get_config("internlm2-1.8b"), 0) == {}
