"""The port's configurations and model specs against the JAX package's,
and its models at the smoke configs of the configurations added last: the
dense gemma-7b (GeGLU, head_dim 256, K = H, tied and scaled embeddings),
internlm2-20b and qwen2-72b (QKV bias), and the MoE family, deepseek-v2-236b
(MLA, a dense first layer, top-6 of 160 experts and 2 shared experts; the
smoke config top-2 of 8) and llama4-maverick (attention and MoE layers
interleaved, top-1).

Parameters are the reference's ``init_params`` as numpy arrays, handed to
the port through ``convert.params_from_numpy``.  Logits are held at 1e-4
relative in a ``dtype="float32"`` config and at 2e-2 in bf16, the limits
of tests/test_torch_models.py.  In float32 both packages' caches are
allocated in float32 here: a bf16 cache rounds its entries, and where the
two packages' float32 values straddle a rounding boundary (MLA's latent
holds a few such entries at the smoke config) decode differs by a bf16 ulp
of a cache entry, far above float32 rounding.  Prompt lengths are not
multiples of ``decode_tail`` (8), where the reference's engine corrupts its
cache (ROADMAP queue C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import OFFLOAD_ARCHS as J_OFFLOAD_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import init_cache_specs as j_cache_specs
from repro.models import init_params as j_init_params
from repro.models import lm as jlm
from repro.models import make_decode_fn as j_decode_fn
from repro.models import make_prefill_fn as j_prefill_fn
from repro.models import param_specs as j_param_specs
from repro.serve import Engine as JEngine
from repro_torch.configs import ARCHS, OFFLOAD_ARCHS, get_config
from repro_torch.convert import params_from_numpy, to_host_f32
from repro_torch.models import (ModelConfig, cast_params, init_cache_specs,
                                init_params, lm, make_decode_fn,
                                make_loss_fn, make_prefill_fn, param_specs)
from repro_torch.models.spec import ParamSpec
from repro_torch.serve import Engine

NEW = ["gemma-7b", "internlm2-20b", "qwen2-72b", "deepseek-v2-236b",
       "llama4-maverick-400b-a17b"]
FRONTENDS = ["llava-next-mistral-7b", "whisper-base"]
B = 2


def configs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


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


# -- the registry ---------------------------------------------------------------

def test_archs_are_the_reference_decoder_only_configs():
    """Every configuration of the reference, the eight decoder-only ones
    and the two frontends, field for field, full and reduced for smoke, in
    the reference's order; OFFLOAD_ARCHS the same."""
    assert list(ARCHS) == list(J_ARCHS)
    assert len(ARCHS) == 10 and set(FRONTENDS) <= set(ARCHS)
    assert OFFLOAD_ARCHS == J_OFFLOAD_ARCHS
    for arch in ARCHS:
        for smoke in (False, True):
            assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
                dataclasses.asdict(j_get_config(arch, smoke=smoke)), arch
    ds = get_config("deepseek-v2-236b", smoke=True)
    assert (ds.kv_lora_rank, ds.q_lora_rank, ds.rope_head_dim,
            ds.nope_head_dim, ds.v_head_dim) == (16, 32, 8, 16, 16)
    assert (ds.n_experts, ds.top_k, ds.n_shared_experts, ds.d_ff_expert,
            ds.n_layers) == (8, 2, 1, 32, 3)


@pytest.mark.parametrize("arch", NEW)
def test_param_and_cache_specs_match_reference(arch):
    """Names, shapes, dtypes, logical axes and init kinds, full size and
    smoke."""
    for smoke in (False, True):
        jcfg, cfg = j_get_config(arch, smoke=smoke), get_config(arch,
                                                                smoke=smoke)
        want, got = j_param_specs(jcfg), param_specs(cfg)
        assert sorted(got) == sorted(want)
        for k, s in got.items():
            w = want[k]
            assert (s.shape, s.dtype, s.axes, s.init) == (
                w.shape, jnp.dtype(w.dtype).name, w.axes, w.init), k
        want, got = j_cache_specs(jcfg, 3, 20), init_cache_specs(cfg, 3, 20)
        assert sorted(got) == sorted(want)
        for k, s in got.items():
            assert (s.shape, s.dtype, s.axes) == (
                want[k].shape, jnp.dtype(want[k].dtype).name, want[k].axes), k


@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontends_raise_naming_item_12(arch):
    """The frontends, once refused naming ROADMAP queue A item 12, are
    ported: every entry point builds for them (the config made from the
    reference's fields, as before), and the specs carry the frontend's own
    parameters and cross-attention cache."""
    cfg = ModelConfig(**dataclasses.asdict(j_get_config(arch, smoke=True)))
    assert cfg == get_config(arch, smoke=True)
    for fn in (make_loss_fn, make_prefill_fn, make_decode_fn):
        assert callable(fn(cfg))
    specs = param_specs(cfg)
    cache = init_cache_specs(cfg, 1, 8, cfg.enc_seq)
    if arch == "whisper-base":
        assert "enc_norm" in specs and "g0/p0/x_wq" in specs
        assert cache["g0/p0/xk"].shape == (cfg.n_layers, 1, cfg.enc_seq,
                                           cfg.n_kv_heads, cfg.hd)
    else:
        assert specs["mm_proj"].shape == (cfg.d_model, cfg.d_model)
        assert not any(k.endswith("/xk") for k in cache)


def test_init_params_scales_in_place_bit_for_bit():
    """``init_params`` scales each draw in place; the values are the
    earlier out-of-place expression's, ``(w * std).to(dtype)``, bit for
    bit, in float32 and bf16 (deepseek-v2's ``param_dtype``)."""
    from repro_torch.models.spec import _fan_in
    specs = {"a": ParamSpec((3, 40, 24), "bfloat16",
                            ("layers", None, None)),
             "b": ParamSpec((64, 512), "float32", (None, None),
                            init="embed"),
             "c": ParamSpec((17, 5), "bfloat16", (None, None), init="small"),
             "d": ParamSpec((9,), "float32", (None,))}
    got = init_params(specs, 11, device="cpu")
    for i, name in enumerate(sorted(specs)):
        spec = specs[name]
        gen = torch.Generator().manual_seed((11 * 1_000_003 + i) % (1 << 63))
        w = torch.randn(spec.shape, generator=gen, dtype=torch.float32)
        std = {"embed": 0.02, "small": 1e-4}.get(spec.init,
                                                 _fan_in(spec) ** -0.5)
        old = (w * std).to(getattr(torch, spec.dtype))
        assert got[name].dtype == old.dtype
        assert torch.equal(got[name].view(torch.int16 if spec.dtype ==
                                          "bfloat16" else torch.int32),
                           old.view(torch.int16 if spec.dtype == "bfloat16"
                                    else torch.int32)), name


# -- prefill / decode against the reference ------------------------------------

def _f32_cache(specs, lib):
    return {k: lib.zeros(v.shape, dtype=lib.float32) for k, v in specs.items()}


def _both_prefill_decode(arch, dtype, S=13, steps=3):
    jcfg, cfg = configs(arch, dtype)
    params = numpy_params(jcfg)
    toks = prompt(cfg, S + steps)
    T = S + steps + 1
    jcs, cs = j_cache_specs(jcfg, B, T), init_cache_specs(cfg, B, T)
    if dtype == "float32":
        jcache, cache = _f32_cache(jcs, jnp), _f32_cache(cs, torch)
    else:
        jcache = {k: jnp.zeros(v.shape, jnp.dtype(v.dtype))
                  for k, v in jcs.items()}
        cache = {k: torch.zeros(v.shape, dtype=getattr(torch, v.dtype))
                 for k, v in cs.items()}
    jl, jcache = j_prefill_fn(jcfg)(params, {"inputs": jnp.asarray(toks[:, :S])},
                                    jcache)
    jout = [np.asarray(jl, np.float32)]
    jdec = j_decode_fn(jcfg)
    for i in range(steps):
        jl, jcache = jdec(params, jcache, jnp.asarray(toks[:, S + i:S + i + 1]),
                          jnp.int32(S + i))
        jout.append(np.asarray(jl, np.float32))
    tp = cast_params(cfg, params_from_numpy(cfg, params, device="cpu"))
    tl, cache = make_prefill_fn(cfg)(tp, {"inputs": t(toks[:, :S]).long()},
                                     cache)
    tout = [to_host_f32(tl)]
    dec = make_decode_fn(cfg)
    for i in range(steps):
        tl, cache = dec(tp, cache, t(toks[:, S + i:S + i + 1]).long(), S + i)
        tout.append(to_host_f32(tl))
    return jout, tout


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_prefill_decode_logits_match_reference(arch, dtype, tol):
    """S = 13, three decode steps (no merge crosses)."""
    jout, tout = _both_prefill_decode(arch, dtype)
    for i, (a, b) in enumerate(zip(tout, jout)):
        assert a.shape == b.shape == (B, 1, 512)
        assert rel_err(a, b) < tol, (i, rel_err(a, b))


@pytest.mark.parametrize("arch", NEW)
def test_prefill_decode_consistent(arch):
    """decode(prefill(17), token 17) against prefill(18)'s last logits
    through the port's engine, at tests/test_models.py's tolerance (0.08
    for MoE configs, whose capacity drops differ between the two token
    counts; 0.02 otherwise)."""
    _, cfg = configs(arch, "bfloat16")
    tp = init_params(param_specs(cfg), 1, device="cpu")
    S = 17
    toks = prompt(cfg, S + 1)
    eng = Engine(cfg, tp, batch=B, max_len=S + 1, device="cpu")
    full = to_host_f32(eng._prefill(eng.params, {"inputs": t(toks).long()},
                                    eng.cache)[0])
    eng.prefill({"inputs": toks[:, :S]})
    err = rel_err(to_host_f32(eng.decode_logits(toks[:, S:])), full)
    assert err < (0.08 if cfg.n_experts else 0.02), err


@pytest.mark.parametrize("arch", NEW)
def test_greedy_tokens_match_reference(arch):
    """Float32 config: 12 greedy tokens from a 13-token prompt through both
    engines (merges at 16 and 24) are the same."""
    jcfg, cfg = configs(arch)
    params = numpy_params(jcfg, seed=4)
    toks = prompt(cfg, 13, seed=8)
    want = JEngine(jcfg, params, batch=B, max_len=32).generate(
        {"inputs": jnp.asarray(toks)}, 12)
    eng = Engine(cfg, params_from_numpy(cfg, params, device="cpu"), batch=B,
                 max_len=32, device="cpu")
    np.testing.assert_array_equal(eng.generate({"inputs": toks}, 12),
                                  np.asarray(want))


# -- QKV bias, MHA at head_dim 256 ----------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_qkv_bias_matches_reference(dtype, tol):
    """qwen2-72b's smoke config with random (nonzero) QKV biases: prefill
    and decode logits against the reference's."""
    jcfg, cfg = configs("qwen2-72b", dtype)
    assert cfg.qkv_bias
    params = numpy_params(jcfg)
    rng = np.random.default_rng(3)
    for k in [k for k in params if k.split("/")[-1] in ("bq", "bk", "bv")]:
        params[k] = (rng.standard_normal(params[k].shape) * 0.5).astype(
            params[k].dtype)
    S, T = 11, 14
    toks = prompt(cfg, S + 1)
    jc = _f32_cache(j_cache_specs(jcfg, B, T), jnp)
    jl, jc = j_prefill_fn(jcfg)(params, {"inputs": jnp.asarray(toks[:, :S])},
                                jc)
    jl2, _ = j_decode_fn(jcfg)(params, jc, jnp.asarray(toks[:, S:]),
                               jnp.int32(S))
    tp = cast_params(cfg, params_from_numpy(cfg, params, device="cpu"))
    c = _f32_cache(init_cache_specs(cfg, B, T), torch)
    tl, c = make_prefill_fn(cfg)(tp, {"inputs": t(toks[:, :S]).long()}, c)
    tl2, _ = make_decode_fn(cfg)(tp, c, t(toks[:, S:]).long(), S)
    assert rel_err(to_host_f32(tl), jl) < tol
    assert rel_err(to_host_f32(tl2), jl2) < tol
    # the biases matter: without them the logits move far
    zero = dict(params, **{k: np.zeros_like(v) for k, v in params.items()
                           if k.split("/")[-1] in ("bq", "bk", "bv")})
    tz = cast_params(cfg, params_from_numpy(cfg, zero, device="cpu"))
    c = _f32_cache(init_cache_specs(cfg, B, T), torch)
    assert rel_err(to_host_f32(make_prefill_fn(cfg)(
        tz, {"inputs": t(toks[:, :S]).long()}, c)[0]), jl) > 10 * tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_mha_head_dim_256_layer_matches_reference(dtype, tol):
    """One gemma-7b attention layer (K = H = 4 heads of 256, GeGLU MLP) at
    d_model 64 over 21 positions: the port's prefill block (the attention
    kernel's plain version) against the reference's block."""
    jcfg, cfg = configs("gemma-7b", dtype)
    jcfg, cfg = (dataclasses.replace(c, head_dim=256) for c in (jcfg, cfg))
    assert cfg.n_heads == cfg.n_kv_heads == 4 and cfg.act == "geglu"
    params = numpy_params(jcfg)
    p = {k[len("g0/p0/"):]: v[0] for k, v in params.items()
         if k.startswith("g0/p0/")}
    jp = jlm._cast_params(jcfg, {k: jnp.asarray(v) for k, v in p.items()})
    tp = cast_params(cfg, {k: t(v) for k, v in p.items()})
    x = (np.random.default_rng(6).standard_normal((B, 21, 64)) * 0.5).astype(
        np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = jlm._mlp_res(jcfg, jp, jlm._attn_block(jcfg, jp, jx,
                                                  jnp.arange(21)))
    got, (k, v) = lm._attn_block(cfg, tp, t(x).to(getattr(torch, dtype)),
                                 torch.arange(21))
    assert k.shape == (B, 21, 4, 256)
    got = lm._mlp_res(cfg, tp, got)
    assert rel_err(to_host_f32(got), want) < tol
