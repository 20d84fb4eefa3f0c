"""The port's dense model against the JAX package's, on the same numpy inputs.

Parameters are made once by the reference's ``init_params`` and handed to
the port through ``convert.params_from_numpy`` (the two packages draw
different random numbers from a seed).  Layers are held at 1e-5 in float32
(XLA's and PyTorch's ``sin``/``cos`` and their summation orders differ in
the last bits).  Prefill and decode logits are held at 1e-4 relative in a
``dtype="float32"`` config, and at 2e-2 in the bf16 config: there the
reference's prefill runs ``blockwise_attention``, which rounds q*scale and
p to bf16, and the port's kernel (its plain version here) does not.  Prompt
lengths of parity tests are not multiples of ``decode_tail`` (8 in the
smoke config), where the reference's engine corrupts its cache (ROADMAP
queue C); the consistency tests show that case separately.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
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
from repro.serve import Engine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, to_host_f32, tree_from_numpy
from repro_torch.models import (cast_params, init_cache_specs, init_params,
                                layers, make_decode_fn, make_prefill_fn,
                                param_specs)
from repro_torch.serve import Engine

ARCH = "internlm2-1.8b"
B = 2


def configs(dtype="bfloat16"):
    """(reference config, port config): the smoke config of both packages,
    compute dtype ``dtype``."""
    return (dataclasses.replace(j_get_config(ARCH, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype))


def numpy_params(jcfg, seed=1):
    return {k: np.asarray(v) for k, v in
            j_init_params(j_param_specs(jcfg), jax.random.PRNGKey(seed)).items()}


def prompt(cfg, n, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, n)).astype(np.int32)


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1e-6, np.abs(b).max()))


def test_smoke_config_matches_reference():
    """``get_config(name, smoke=True)``: the reference's reduction, field
    for field, and the full config unchanged."""
    for smoke in (True, False):
        want = dataclasses.asdict(j_get_config(ARCH, smoke=smoke))
        assert dataclasses.asdict(get_config(ARCH, smoke=smoke)) == want


# -- layers --------------------------------------------------------------------

def test_rms_norm_rope_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = (rng.standard_normal(16) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(t(x), t(scale), 1e-5).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        rtol=1e-5, atol=1e-5)
    pos = np.arange(3, 10)
    np.testing.assert_allclose(
        layers.rope(t(x), t(pos), 1e6).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32) for k, s in
         {"wi": (16, 32), "wg": (16, 32), "wo": (32, 16)}.items()}
    h = x.reshape(-1, 16)
    for act in ("silu", "geglu", "gelu"):
        pp = p if act != "gelu" else {k: v for k, v in p.items() if k != "wg"}
        np.testing.assert_allclose(
            layers.mlp({k: t(v) for k, v in pp.items()}, t(h), act).numpy(),
            np.asarray(jlayers.mlp({k: jnp.asarray(v) for k, v in pp.items()},
                                   jnp.asarray(h), act)),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_reference(dtype):
    """The plain decode paths (XLA code in the reference): one query
    against a ring cache (with and without a window) and against the
    two-tier cache, at 1e-5 in float32 and 2e-2 in bf16."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(4)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32).astype(npdt)

    q, k, v = mk(2, 1, 4, 16), mk(2, 24, 2, 16), mk(2, 24, 2, 16)
    tk, tv = mk(2, 8, 2, 16), mk(2, 8, 2, 16)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    tt = lambda a: tree_from_numpy({"a": a}, device="cpu")["a"]  # noqa: E731
    jj = jnp.asarray
    pairs = [(tattn.decode_attention(tt(q), tt(k), tt(v), 19, window=w),
              jattn.decode_attention(jj(q), jj(k), jj(v), 19, window=w))
             for w in (None, 5)]
    for pos in (16, 21):  # tail empty but the new slot; tail partly full
        pairs.append((
            tattn.decode_attention_two_tier(tt(q), tt(k), tt(v), tt(tk),
                                            tt(tv), pos),
            jattn.decode_attention_two_tier(jj(q), jj(k), jj(v), jj(tk),
                                            jj(tv), jnp.int32(pos))))
    for got, want in pairs:
        np.testing.assert_allclose(to_host_f32(got),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_cache_specs_match_reference():
    jcfg, cfg = configs()
    for batch, T in ((2, 32), (3, 5)):
        want = j_cache_specs(jcfg, batch, T)
        got = init_cache_specs(cfg, batch, T)
        assert sorted(got) == sorted(want)
        for k, s in got.items():
            assert (s.shape, s.dtype, s.axes) == \
                (want[k].shape, jnp.dtype(want[k].dtype).name, want[k].axes), k
    full = init_cache_specs(get_config(ARCH), 4, 4096)
    assert full["g0/p0/k"].shape == (24, 4, 4096, 8, 128)
    assert full["g0/p0/tk"].shape == (24, 4, 128, 8, 128)


def test_init_params_kinds_and_scales():
    _, cfg = configs()
    specs = param_specs(cfg)
    a = init_params(specs, 7, device="cpu")
    b = init_params(specs, 7, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in specs)
    assert sorted(a) == sorted(specs)
    for k, s in specs.items():
        assert tuple(a[k].shape) == s.shape
        assert str(a[k].dtype) == f"torch.{s.dtype}"
    assert torch.count_nonzero(a["final_norm"]) == 0  # zeros
    assert abs(float(a["embed/tok"].std()) - 0.02) < 2e-3  # embed
    wq = a["g0/p0/wq"]  # fan_in over (d_model,) without the layers axis
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.01


# -- prefill / decode against the reference -------------------------------------

def _both_prefill_decode(dtype, S, steps=3):
    jcfg, cfg = configs(dtype)
    params = numpy_params(jcfg)
    toks = prompt(cfg, S + steps)
    T = S + steps + 1
    # reference
    jcs = j_cache_specs(jcfg, B, T)
    jcache = {k: jnp.zeros(v.shape, jnp.dtype(v.dtype)) for k, v in jcs.items()}
    jl, jcache = j_prefill_fn(jcfg)(params, {"inputs": jnp.asarray(toks[:, :S])},
                                    jcache)
    jout = [np.asarray(jl, np.float32)]
    jdec = j_decode_fn(jcfg)
    for i in range(steps):
        jl, jcache = jdec(params, jcache, jnp.asarray(toks[:, S + i:S + i + 1]),
                          jnp.int32(S + i))
        jout.append(np.asarray(jl, np.float32))
    # port
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
def test_prefill_decode_logits_match_reference(dtype, tol):
    """S = 13, three decode steps (no merge crosses: the reference's decode
    function is called directly, as the engine would between merges)."""
    jout, tout = _both_prefill_decode(dtype, 13)
    for i, (a, b) in enumerate(zip(tout, jout)):
        assert a.shape == b.shape == (B, 1, 512)
        assert rel_err(a, b) < tol, (i, rel_err(a, b))


# -- prefill / decode consistency, at and off multiples of decode_tail ----------

def _consistency(eng, decode, S, toks, full_logits):
    eng.prefill({"inputs": toks[:, :S]})
    return rel_err(decode(toks[:, S:S + 1]), full_logits)


@pytest.mark.parametrize("S", [17, 16])
def test_port_prefill_decode_consistent(S):
    """decode(prefill(S), token_S) == prefill(S+1)'s last logits, through
    the engine (which merges the tail before the step at a multiple of
    Tt); tolerance of tests/test_models.py."""
    _, cfg = configs()
    assert S % cfg.decode_tail == (0 if S == 16 else 1)
    tp = init_params(param_specs(cfg), 1, device="cpu")
    toks = prompt(cfg, S + 1)
    eng = Engine(cfg, tp, batch=B, max_len=S + 1, device="cpu")
    eng.prefill({"inputs": toks})
    full = to_host_f32(eng._prefill(eng.params, {"inputs": t(toks).long()},
                                    eng.cache)[0])
    err = _consistency(eng, lambda tk: to_host_f32(eng.decode_logits(tk)), S,
                       toks, full)
    assert err < 0.02, err


def test_reference_engine_inconsistent_at_multiple_of_decode_tail():
    """The fault the port does not copy: after a prompt of 16 = 2 * Tt
    tokens the reference engine's first step merges its empty tail over
    main[8:16] (ROADMAP queue C); at 17 it is consistent."""
    jcfg, _ = configs()
    params = numpy_params(jcfg)
    errs = {}
    for S in (16, 17):
        toks = prompt(jcfg, S + 1)
        eng = JEngine(jcfg, params, batch=B, max_len=S + 1)
        full = np.asarray(eng._prefill(params, {"inputs": jnp.asarray(toks)},
                                       eng._zero_cache())[0], np.float32)

        def decode(tk):
            eng._maybe_merge()
            lg, eng.cache = eng._decode(params, eng.cache, jnp.asarray(tk),
                                        jnp.int32(eng.pos))
            return np.asarray(lg, np.float32)

        errs[S] = _consistency(eng, decode, S, toks, full)
    assert errs[17] < 0.02 and errs[16] > 0.1, errs


def test_unported_blocks_raise():
    """Every block kind is ported: ``attn``, ``moe``, ``ssm``, ``rglru`` and
    ``local_attn``, and the frontends' (an encoder-decoder's ``xattn``
    decoder blocks over its ``enc_attn`` encoder, once refused naming
    item 12) build: specs with the encoder's stack and the cross-attention
    weights, a cache with ``xk``/``xv``; MLA still pairs with no
    encoder-decoder configuration of the reference."""
    from repro_torch.models import ModelConfig
    moe = ModelConfig(name="m", family="moe", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=64,
                      n_experts=8, top_k=2, d_ff_expert=32)
    make_prefill_fn(moe)
    assert "g0/p0/we_up" in param_specs(moe)
    assert "g0/p0/tk" in init_cache_specs(moe, 1, 8)
    encdec = dataclasses.replace(moe, family="audio", n_experts=0,
                                 enc_layers=2, enc_seq=16)
    assert encdec.groups() == [(2, ("xattn",))]
    make_prefill_fn(encdec)
    cache = init_cache_specs(encdec, 1, 8, 16)
    assert cache["g0/p0/xk"].shape == (2, 1, 16, 2, 16)
    assert list(cache) == [f"g0/p0/{k}" for k in ("k", "v", "tk", "tv",
                                                  "xk", "xv")]
    specs = param_specs(encdec)
    assert specs["enc/g0/p0/wq"].shape == (2, 64, 64)
    assert {"enc_norm", "g0/p0/normx", "g0/p0/x_wk"} <= set(specs)
    with pytest.raises(ValueError, match="not a configuration"):
        make_prefill_fn(dataclasses.replace(encdec, attn_kind="mla"))
