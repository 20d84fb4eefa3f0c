"""The port's MoE layer against the JAX package's, on the CPU.

Routing is held equal exactly: the experts chosen, each assignment's
position inside its expert and whether it is kept under the capacity,
given the reference's own float32 router logits; the renormalized gates
too, given the reference's softmax (XLA's and PyTorch's ``exp`` differ in
the last bit, so from the logits the probabilities agree to float32
rounding, which the gates are held to).  ``moe_mlp`` at the smoke configs
of deepseek-v2-236b (top-2 of 8, a shared expert) and llama4-maverick
(top-1): 1e-5 in float32, 2e-2 in bf16, the load-balance loss within
1e-6.  Parameters are the reference's ``init_params`` as numpy arrays.
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
from repro.models import moe as jmoe
from repro.models import param_specs as j_param_specs
from repro_torch.configs import get_config
from repro_torch.convert import to_host_f32, tree_from_numpy
from repro_torch.models import moe

ARCHS = {"deepseek-v2-236b": "g1/p0/", "llama4-maverick-400b-a17b": "g0/p1/"}
MOE_KEYS = ("router", "we_up", "we_gate", "we_down", "ws_up", "ws_gate",
            "ws_down")


def layer(arch, dtype="float32", seed=1):
    """(reference config, port config, one MoE layer's numpy params)."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    pre = ARCHS[arch]
    tree = j_init_params(j_param_specs(jcfg), jax.random.PRNGKey(seed))
    p = {}
    for name in MOE_KEYS:
        if pre + name in tree:
            a = np.asarray(tree[pre + name])[0]
            # matmul weights in the compute dtype, the router in float32
            p[name] = a if name == "router" else a.astype(
                ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    return jcfg, cfg, p


def _t(tree):
    return tree_from_numpy(tree, device="cpu")


def reference_routing(logits, k, E, cap):
    """The reference's routing lines (``moe_mlp_dense``), on its logits."""
    probs = jax.nn.softmax(logits, axis=-1)
    gates, eidx = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    e_flat = eidx.reshape(-1)
    oh = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    csum = jnp.cumsum(oh, axis=0) - oh
    pos_in_e = jnp.take_along_axis(csum, e_flat[:, None], axis=1)[:, 0]
    keep = pos_in_e < cap
    dest = jnp.where(keep, e_flat * cap + pos_in_e, E * cap)
    return {k_: np.asarray(v) for k_, v in dict(
        probs=probs, gates=gates, eidx=eidx, pos_in_e=pos_in_e, keep=keep,
        dest=dest).items()}


@pytest.mark.parametrize("E,k,cap", [(8, 2, 16), (160, 6, 8), (128, 1, 8)])
def test_routing_equal_to_reference(E, k, cap):
    """500 tokens of the reference's float32 router logits (x @ router):
    experts, positions, kept flags and dispatch rows equal exactly, gates
    bit-equal from the reference's probabilities; ``cap`` makes the larger
    expert counts drop assignments."""
    rng = np.random.default_rng(E)
    x = rng.standard_normal((500, 32)).astype(np.float32)
    router = (rng.standard_normal((32, E)) * 32 ** -0.5).astype(np.float32)
    logits = np.array(jnp.asarray(x) @ jnp.asarray(router))
    want = reference_routing(jnp.asarray(logits), k, E, cap)
    probs, gates, eidx = moe.route(torch.from_numpy(logits), k)
    pos, keep, dest = moe.assignment_slots(eidx, E, cap)
    np.testing.assert_array_equal(eidx.numpy(), want["eidx"])
    np.testing.assert_array_equal(pos.numpy(), want["pos_in_e"])
    np.testing.assert_array_equal(keep.numpy(), want["keep"])
    np.testing.assert_array_equal(dest.numpy(), want["dest"])
    if E > 8:
        assert not want["keep"].all()  # the capacity binds
    np.testing.assert_allclose(probs.numpy(), want["probs"], rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(gates.numpy(), want["gates"], rtol=1e-6,
                               atol=0)
    g2, e2 = moe.top_k_gates(torch.from_numpy(want["probs"].copy()), k)
    np.testing.assert_array_equal(g2.numpy(), want["gates"])
    np.testing.assert_array_equal(e2.numpy(), want["eidx"])


def test_top_k_takes_the_lower_index_among_ties():
    """Exact ties in the probabilities: the lower expert index first, as
    ``jax.lax.top_k`` orders them."""
    probs = np.array([[0.1, 0.3, 0.3, 0.1, 0.2],
                      [0.2, 0.2, 0.2, 0.2, 0.2],
                      [0.0, 0.25, 0.25, 0.25, 0.25]], np.float32)
    for k in (1, 2, 3, 4):
        _, want = jax.lax.top_k(jnp.asarray(probs), k)
        _, got = moe.top_k_gates(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert moe.top_k_gates(torch.from_numpy(probs), 3)[1].tolist() == [
        [1, 2, 4], [0, 1, 2], [1, 2, 3]]


def test_moe_capacity_matches_reference():
    for args in ((26, 8, 2, 1.25), (8000, 160, 6, 1.25), (8000, 128, 1, 1.25),
                 (4, 128, 1, 1.25), (8004, 160, 6, 160 / 6)):
        assert moe.moe_capacity(*args) == jmoe.moe_capacity(*args)


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("capacity", [None, 3])
def test_moe_mlp_matches_reference(arch, dtype, tol, capacity):
    """``moe_mlp`` on (2, 13, 64) inputs at the smoke config: y within
    ``tol`` of the reference's, aux within 1e-6; ``capacity=3`` drops
    assignments (checked), the default keeps them all."""
    jcfg, cfg, p = layer(arch, dtype)
    x = (np.random.default_rng(3).standard_normal((2, 13, cfg.d_model))
         * 0.5).astype(np.float32)
    x = x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x
    jy, jaux = jmoe.moe_mlp(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), capacity=capacity)
    tp = _t(p)
    y, aux = moe.moe_mlp(cfg, tp, _t({"x": x})["x"], capacity=capacity)
    assert y.dtype == getattr(torch, dtype) and y.shape == x.shape
    np.testing.assert_allclose(to_host_f32(y), np.asarray(jy, np.float32),
                               atol=tol, rtol=tol)
    assert abs(float(aux) - float(jaux)) < 1e-6
    T, cap = 26, capacity or moe.moe_capacity(26, cfg.n_experts, cfg.top_k,
                                              cfg.capacity_factor)
    xf = _t({"x": x})["x"].reshape(T, -1)
    _, _, eidx = moe.route(xf.float() @ tp["router"], cfg.top_k)
    kept = bool(moe.assignment_slots(eidx, cfg.n_experts, cap)[1].all())
    assert kept == (capacity is None)


def test_moe_combine_is_deterministic():
    """The combine adds a token's k contributions one after another in
    bf16, with no atomics: the same bits twice."""
    _, cfg, p = layer("deepseek-v2-236b", "bfloat16")
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator().manual_seed(
        4)).to(torch.bfloat16)
    tp = _t(p)
    a, _ = moe.moe_mlp(cfg, tp, x)
    b, _ = moe.moe_mlp(cfg, tp, x)
    assert torch.equal(a, b)


def test_moe_mesh_is_not_ported():
    _, cfg, p = layer("llama4-maverick-400b-a17b")
    with pytest.raises(NotImplementedError, match="queue A14"):
        moe.moe_mlp(cfg, _t(p), torch.zeros(1, 2, cfg.d_model),
                    mesh=object())
