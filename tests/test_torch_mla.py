"""The port's Multi-head Latent Attention against the JAX package's.

deepseek-v2-236b's smoke config (4 heads, q_lora 32, kv_lora 16, rope /
nope / value head dims 8 / 16 / 16), one layer's parameters from the
reference's ``init_params`` as numpy arrays: the prefill path
(``mla_attention``, through the attention kernel's plain version with a
query/key head dimension of 24 and a value head dimension of 16), the
training path (``blockwise_attention``) and the absorbed decode over the
two-tier latent cache across tail merges, and over a single-tier cache.
1e-5 in float32, 2e-2 in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.models import mla as jmla
from repro.models import param_specs as j_param_specs
from repro_torch.configs import get_config
from repro_torch.convert import to_host_f32, tree_from_numpy
from repro_torch.models import mla

ARCH = "deepseek-v2-236b"
B = 2
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
NPDT = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def layer(dtype, seed=1):
    """(reference config, port config, layer 0's numpy MLA params, cast as
    the models cast them: matmul weights to ``dtype``, norms float32)."""
    jcfg = dataclasses.replace(j_get_config(ARCH, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    tree = j_init_params(j_param_specs(jcfg), jax.random.PRNGKey(seed))
    p = {}
    for name in ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"):
        a = np.asarray(tree[f"g0/p0/{name}"])[0]
        p[name] = a.astype(np.float32) if "norm" in name else a.astype(
            NPDT[dtype])
    return jcfg, cfg, p


def _t(tree):
    return tree_from_numpy(tree, device="cpu")


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _x(cfg, S, dtype, seed):
    return (np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)) * 0.5).astype(np.float32).astype(NPDT[dtype])


def _close(got, want, dtype):
    np.testing.assert_allclose(to_host_f32(got), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True])
def test_mla_attention_matches_reference(dtype, train):
    """A prompt of 21 from position 0: the output and the latent cache
    entries (c_kv, k_rope); ``train`` runs ``blockwise_attention``, else
    the prefill kernel's plain version."""
    jcfg, cfg, p = layer(dtype)
    x = _x(cfg, 21, dtype, 2)
    jout, (jc, jk) = jmla.mla_attention(jcfg, _j(p), jnp.asarray(x),
                                        jnp.arange(21))
    out, (c, k) = mla.mla_attention(cfg, _t(p), _t({"x": x})["x"],
                                    torch.arange(21), train=train)
    assert out.shape == (B, 21, cfg.d_model) and out.dtype == c.dtype
    for got, want in ((out, jout), (c, jc), (k, jk)):
        _close(got, want, dtype)


def _caches(cfg, T, rng):
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    mk = lambda *s: rng.standard_normal(s).astype(np.float32).astype(  # noqa
        ml_dtypes.bfloat16)
    return mk(B, T, r), mk(B, T, dr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_two_tier_across_merges_matches_reference(dtype):
    """Positions 13 to 30 with a tail of 8 slots: the tail merges into
    main before the steps at 16 and 24, as the engines merge it.  Each
    step's output and the tail after it, against the reference's."""
    jcfg, cfg, p = layer(dtype)
    rng = np.random.default_rng(5)
    Tm, Tt = 32, cfg.decode_tail
    main_c, main_k = _caches(cfg, Tm, rng)
    tail_c, tail_k = _caches(cfg, Tt, rng)
    jm, jt = [jnp.asarray(main_c), jnp.asarray(main_k)], [
        jnp.asarray(tail_c), jnp.asarray(tail_k)]
    tm, tt = [_t({"a": main_c})["a"], _t({"a": main_k})["a"]], [
        _t({"a": tail_c})["a"], _t({"a": tail_k})["a"]]
    jp, tp = _j(p), _t(p)
    for pos in range(13, 31):
        if pos % Tt == 0:  # the engines' merge of a full tail
            for i in range(2):
                jm[i] = jm[i].at[:, pos - Tt:pos].set(jt[i])
                tm[i][:, pos - Tt:pos] = tt[i]
        x = _x(cfg, 1, dtype, pos)
        jout, jt[0], jt[1] = jmla.mla_decode_two_tier(
            jcfg, jp, jnp.asarray(x), jnp.int32(pos), *jm, *jt)
        out, _, _ = mla.mla_decode_two_tier(cfg, tp, _t({"x": x})["x"], pos,
                                            *tm, *tt)
        _close(out, jout, dtype)
        for got, want in zip(tt, jt):  # bf16 caches: equal where both
            _close(got, want, dtype)   # round the same float32 value


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_single_tier_matches_reference(dtype):
    jcfg, cfg, p = layer(dtype)
    rng = np.random.default_rng(6)
    c, k = _caches(cfg, 24, rng)
    x = _x(cfg, 1, dtype, 7)
    jout, jc, jk = jmla.mla_decode(jcfg, _j(p), jnp.asarray(x), jnp.int32(17),
                                   jnp.asarray(c), jnp.asarray(k), 18)
    tc, tk = _t({"a": c})["a"], _t({"a": k})["a"]
    out, c2, k2 = mla.mla_decode(cfg, _t(p), _t({"x": x})["x"], 17, tc, tk,
                                 18)
    assert c2 is tc and k2 is tk  # written in place
    _close(out, jout, dtype)
    _close(c2, jc, dtype)
    _close(k2, jk, dtype)
