"""The expert-parallel MoE on a mesh of four CPU processes.

``repro_torch.models.moe.moe_mlp`` under ``use_rules(train_rules(), mesh)``
on four gloo processes, on a (2, 2) ``("data", "model")`` and a (2, 1, 2)
``("pod", "data", "model")`` mesh: each rank holds its data shard of x
(replicated over "model") and its model rank's E/n experts.  Held, at the
deepseek-v2 and llama4-maverick smoke configs with capacity 64 (as
``tests/test_moe_shardmap.py`` runs the reference's):

* against the reference's ``_moe_mlp_shard_map`` on four forced host
  devices (a subprocess), the same numpy parameters and x: y and the aux
  loss, float32 at 1e-5 and bf16 at 2e-2 (relative to the largest |y|);
* against the port's dense dispatch at a capacity where nothing drops, in
  float32 at 1e-5: y, and the gradients of x and of every weight of the
  objective ``sum(y * r) + c * aux``, whose dense form takes the mean over
  the data shards of each shard's aux (what the reference's ``pmean``
  computes).  Each rank's gradient of its share is its part of the global
  one times the data-parallel size (the trainer's mean over the data axes
  then gives the global gradient): x's is divided by it, the weights' are
  averaged over the data ranks.

The reference's own EP gradients, which its test checks only for being
finite, are held to its dense ones the same way, and agree at 1e-5
(``test_reference_ep_gradients_match_its_dense``): the reference has no EP
gradient fault for the port to avoid.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_collectives import (MESHES, finish_reference,  # noqa: F401
                                    one_thread, run_ranks, start_reference)

ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
DTYPES = ("float32", "bfloat16")
B, S, CAP, C_AUX = 4, 8, 64, 0.37
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _layer(arch):
    """The smoke config and the names and (unstacked) shapes of its first
    MoE layer's parameters."""
    from repro_torch.configs import get_config
    from repro_torch.models import param_specs
    cfg = get_config(arch, smoke=True)
    specs = param_specs(cfg)
    prefix = next(k for k in specs if k.endswith("/router"))[:-len("router")]
    return cfg, {k[len(prefix):]: v.shape[1:] for k, v in specs.items()
                 if k.startswith(prefix) and ("router" in k or "/we_" in k
                                              or "/ws_" in k)}


def _inputs() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(7)
    out = {}
    for arch in ARCHS:
        cfg, shapes = _layer(arch)
        for name, shape in shapes.items():
            fan_in = shape[-2]
            out[f"{arch}/{name}"] = (rng.standard_normal(shape)
                                     / np.sqrt(fan_in)).astype(np.float32)
        out[f"{arch}/x"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        out[f"{arch}/r"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return out


def _params(inp, arch, dtype, lib):
    """The layer's parameters in ``dtype`` (the router in float32, as
    ``cast_params`` keeps it), as ``lib`` arrays (``torch`` or ``jnp``)."""
    out = {}
    for key, v in inp.items():
        a, _, name = key.partition("/")
        if a != arch or name in ("x", "r"):
            continue
        dt = "float32" if name == "router" else dtype
        out[name] = (torch.from_numpy(v).to(getattr(torch, dt))
                     if lib == "torch" else lib.asarray(v, dt))
    return out


_REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models.moe import _moe_mlp_shard_map, moe_mlp_dense

inp = dict(np.load(sys.argv[1]))
ARCHS, DTYPES, MESHES = %(ARCHS)r, %(DTYPES)r, %(MESHES)r
CAP, C_AUX = %(CAP)d, %(C_AUX)r
out = {}
for name, (shape, axes) in MESHES.items():
    mesh = jax.make_mesh(shape, axes)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    n_dp = int(np.prod([shape[axes.index(a)] for a in dp]))
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        for dt in DTYPES:
            p = {k.split("/", 1)[1]: jnp.asarray(v, "float32" if k.endswith(
                 "/router") else dt) for k, v in inp.items()
                 if k.startswith(arch + "/") and k.split("/", 1)[1]
                 not in ("x", "r")}
            x = jnp.asarray(inp[arch + "/x"], dt)
            r = jnp.asarray(inp[arch + "/r"], jnp.float32)
            sharding = NamedSharding(mesh, P(dp, None, None))

            def ep(xx, pp):
                return _moe_mlp_shard_map(cfg, pp, xx, mesh, capacity=CAP)

            with mesh:
                y, aux = jax.jit(ep, in_shardings=(sharding, None))(
                    jax.device_put(x, sharding), p)
            key = f"{name}/{arch}/{dt}"
            out[key + "/y"] = np.asarray(y, np.float32)
            out[key + "/aux"] = np.asarray(aux, np.float32)
            if dt != "float32":
                continue

            def j_ep(xx, pp):
                yy, a = ep(xx, pp)
                return (yy.astype(jnp.float32) * r).sum() + C_AUX * a

            def j_dense(xx, pp):
                yy, _ = moe_mlp_dense(cfg, pp, xx, capacity=CAP)
                rows = xx.shape[0] // n_dp
                auxes = [moe_mlp_dense(cfg, pp, xx[i * rows:(i + 1) * rows],
                                       capacity=CAP)[1] for i in range(n_dp)]
                return (yy * r).sum() + C_AUX * sum(auxes) / n_dp

            with mesh:  # as tests/test_moe_shardmap.py takes its grad
                g_ep = jax.jit(jax.grad(j_ep, argnums=(0, 1)))(x, p)
            g_dense = jax.jit(jax.grad(j_dense, argnums=(0, 1)))(x, p)
            for tag, (gx, gp) in (("ep", g_ep), ("dense", g_dense)):
                out[f"{key}/grad_{tag}/x"] = np.asarray(gx)
                for k, v in gp.items():
                    out[f"{key}/grad_{tag}/{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
print("OK")
"""


def ep_worker(directory: str) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import moe_mlp
    from repro_torch.runtime.sharding import (mesh_coords, train_rules,
                                              use_rules)

    dist.init_process_group("gloo")
    rank = dist.get_rank()
    inp = dict(np.load(Path(directory) / "inputs.npz"))
    out = {}
    for name, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes, device="cpu")
        coords = mesh_coords(mesh)
        dp = [a for a in ("pod", "data") if a in axes]
        n_dp = int(np.prod([shape[axes.index(a)] for a in dp]))
        d = 0
        for a in dp:  # row-major over the data axes
            d = d * shape[axes.index(a)] + coords[a]
        m, n_mp = coords["model"], shape[axes.index("model")]
        rows = slice(d * B // n_dp, (d + 1) * B // n_dp)
        for arch in ARCHS:
            cfg = get_config(arch, smoke=True)
            e_loc = cfg.n_experts // n_mp
            for dt in DTYPES:
                p = {k: (v[m * e_loc:(m + 1) * e_loc].clone()
                         if k.startswith("we_") else v).requires_grad_(True)
                     for k, v in _params(inp, arch, dt, "torch").items()}
                x = torch.from_numpy(inp[f"{arch}/x"][rows]).to(
                    getattr(torch, dt)).requires_grad_(True)
                with use_rules(train_rules("pod" in axes), mesh):
                    y, aux = moe_mlp(cfg, p, x, capacity=CAP)
                key = f"{name}/{arch}/{dt}"
                out[key + "/y"] = y.detach().float().numpy()
                out[key + "/aux"] = aux.detach().numpy()
                if dt != "float32":
                    continue
                r = torch.from_numpy(inp[f"{arch}/r"][rows])
                loss = n_dp * (y * r).sum() + C_AUX * aux
                grads = torch.autograd.grad(loss, [x, *p.values()])
                out[key + "/grad/x"] = grads[0].numpy()
                for k, g in zip(p, grads[1:]):
                    out[f"{key}/grad/{k}"] = g.numpy()
    torch.save(out, Path(directory) / f"rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    reference = start_reference(
        _REFERENCE % {"ARCHS": ARCHS, "DTYPES": DTYPES, "MESHES": MESHES,
                      "CAP": CAP, "C_AUX": C_AUX},
        str(tmp / "inputs.npz"), str(tmp / "ref.npz"), log=tmp / "ref.log")
    try:
        run_ranks("test_torch_moe_ep", "ep_worker", str(tmp))
    finally:
        finish_reference(reference, tmp / "ref.log")
    ref = dict(np.load(tmp / "ref.npz"))
    port = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    return inp, ref, port


def _layout(mesh):
    """rank -> (data index, model index), and the data-parallel size."""
    shape, axes = MESHES[mesh]
    n_mp = shape[axes.index("model")]
    return {r: (r // n_mp, r % n_mp) for r in range(4)}, 4 // n_mp


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(1e-6, np.abs(b).max()))


def _dense(inp, arch, n_dp):
    """The port's dense dispatch: y over the whole batch, and the gradients
    of sum(y * r) + c * (the mean over the data shards of each one's aux)."""
    from repro_torch.models.moe import moe_mlp_dense
    cfg, _ = _layer(arch)
    p = {k: v.requires_grad_(True)
         for k, v in _params(inp, arch, "float32", "torch").items()}
    x = torch.from_numpy(inp[f"{arch}/x"]).requires_grad_(True)
    y, _ = moe_mlp_dense(cfg, p, x, capacity=CAP)
    rows = B // n_dp
    aux = sum(moe_mlp_dense(cfg, p, x[i * rows:(i + 1) * rows],
                            capacity=CAP)[1] for i in range(n_dp)) / n_dp
    loss = (y * torch.from_numpy(inp[f"{arch}/r"])).sum() + C_AUX * aux
    grads = torch.autograd.grad(loss, [x, *p.values()])
    return (y.detach().numpy(), aux.detach().numpy(),
            {"x": grads[0].numpy(),
             **{k: g.numpy() for k, g in zip(p, grads[1:])}})


CASES = [(m, a, d) for m in MESHES for a in ARCHS for d in DTYPES]


@pytest.mark.parametrize("mesh,arch,dtype", CASES,
                         ids=["-".join(c) for c in CASES])
def test_ep_matches_reference_ep(results, mesh, arch, dtype):
    _, ref, port = results
    layout, n_dp = _layout(mesh)
    key = f"{mesh}/{arch}/{dtype}"
    y_ref = ref[key + "/y"]
    for r, (d, _) in layout.items():
        rows = slice(d * B // n_dp, (d + 1) * B // n_dp)
        assert _rel(port[r][key + "/y"], y_ref[rows]) < TOL[dtype], r
        np.testing.assert_allclose(port[r][key + "/aux"], ref[key + "/aux"],
                                   rtol=TOL[dtype])


GRAD_CASES = [(m, a) for m in MESHES for a in ARCHS]


@pytest.mark.parametrize("mesh,arch", GRAD_CASES,
                         ids=["-".join(c) for c in GRAD_CASES])
def test_ep_values_and_gradients_match_dense(results, mesh, arch):
    inp, _, port = results
    layout, n_dp = _layout(mesh)
    cfg, _ = _layer(arch)
    y, aux, grads = _dense(inp, arch, n_dp)
    key = f"{mesh}/{arch}/float32"
    n_mp = 4 // n_dp
    e_loc = cfg.n_experts // n_mp
    for r, (d, m) in layout.items():
        rows = slice(d * B // n_dp, (d + 1) * B // n_dp)
        assert _rel(port[r][key + "/y"], y[rows]) < 1e-5, r
        np.testing.assert_allclose(port[r][key + "/aux"], aux, rtol=1e-5)
        assert _rel(port[r][key + "/grad/x"] / n_dp, grads["x"][rows]) \
            < 1e-5, ("x", r)
    for name, want in grads.items():
        if name == "x":
            continue
        for m in range(n_mp):  # the mean over the data ranks
            mean = np.mean([port[r][f"{key}/grad/{name}"]
                            for r, (_, mm) in layout.items() if mm == m], 0)
            block = want[m * e_loc:(m + 1) * e_loc] \
                if name.startswith("we_") else want
            assert _rel(mean, block) < 1e-5, (name, m, _rel(mean, block))


def test_model_ranks_agree(results):
    """The model ranks of a data shard end with the same y and the same
    gradients of x and of the router (the sums over "model" give each the
    whole)."""
    _, _, port = results
    for mesh in MESHES:
        layout, _ = _layout(mesh)
        for arch in ARCHS:
            key = f"{mesh}/{arch}/float32"
            for name in ("/y", "/grad/x", "/grad/router", "/aux"):
                by_d = {}
                for r, (d, _) in layout.items():
                    by_d.setdefault(d, []).append(port[r][key + name])
                for same in by_d.values():
                    assert all(np.array_equal(same[0], o) for o in same), \
                        (mesh, arch, name)


@pytest.mark.parametrize("mesh,arch", GRAD_CASES,
                         ids=["-".join(c) for c in GRAD_CASES])
def test_reference_ep_gradients_match_its_dense(results, mesh, arch):
    """The reference's ``_moe_mlp_shard_map`` gradients (``jax.grad`` of
    the same objective on its mesh) against its dense dispatch's: every
    one, x's and each weight's, within 1e-5."""
    _, ref, _ = results
    key = f"{mesh}/{arch}/float32"
    names = sorted({k.rsplit("/", 1)[1] for k in ref
                    if k.startswith(key + "/grad_ep/")})
    assert {"x", "router", "we_up", "we_down"} <= set(names), names
    errs = {n: _rel(ref[f"{key}/grad_ep/{n}"], ref[f"{key}/grad_dense/{n}"])
            for n in names}
    assert max(errs.values()) < 1e-5, errs
