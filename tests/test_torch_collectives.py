"""The port's collectives against the JAX package's, over four processes.

``repro_torch.runtime.collectives`` on four gloo processes (the port's mesh:
one process a card), on a (2, 2) ``("data", "model")`` and a (2, 1, 2)
``("pod", "data", "model")`` mesh, against ``repro.runtime.collectives``
under ``shard_map`` on four forced host devices in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_moe_shardmap.py`` runs it), on the same numpy inputs: rank r
takes block r of each input, row-major over the mesh axes, as device r does
under ``PartitionSpec(mesh axes)``.  The two all-to-alls and the dispatch
are held bit for bit, the means and ``flash_decode_psum`` at 1e-6; the
all-to-all round trip is the identity, and ``flash_decode_psum`` also
equals an unsharded softmax.  The gradient-carrying reductions (``psum``,
``pmean``, ``replicated``) are held on their own, and so are the
sequence's collectives (``runtime.partition``): a region's ``enter`` and
``leave`` on a stream split along its positions (sequence parallelism,
``train_rules(seq_shard=True)``) and ``seq_gather``/``seq_scatter`` under
it and under token parallelism (multi-pod ``tp=False``), forward and
backward, on model axes of 2 and 4 ranks, against a single-process
reckoning from every rank's inputs.

``run_ranks`` starts the ranks the way ``torch.distributed.run`` does
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), each process
waited for with its own timeout, while the reference runs beside them
(``start_reference``, ``finish_reference``, with its own timeout);
``test_torch_mesh_train.py`` and ``test_torch_moe_ep.py`` use them too.
These files keep their load short, so that it is over before the suite's
last small files run: the reference runs beside the ranks, not before
them, and each file's own torch work runs on one thread (``one_thread``).
A launcher whose coordinator thread is kept from its core between a
rank's death and its respawn can lose the respawn
(``tests/test_spmd.py::test_kill_one_rank_resumes_exactly``; ROADMAP
queue C).
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC, TESTS = str(ROOT / "src"), str(ROOT / "tests")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# (inner, outer) axes of hierarchical_pmean on each mesh: the trainer's,
# and one over "model"
PMEAN_AXES = {"2x2": [("data", None), ("model", "data")],
              "2x1x2": [("data", "pod"), ("model", "pod")]}
E, CAP, D, T, K = 4, 2, 5, 6, 2
RANK_TIMEOUT = 120
# the sequence's collectives: name -> (mesh shape, axes, train_rules
# keywords); the model axis has 2 or 4 ranks
SEQ_MESHES = {
    "sp2": ((2, 2), ("data", "model"), {"seq_shard": True}),
    "sp4": ((1, 4), ("data", "model"), {"seq_shard": True}),
    "tok2": ((2, 1, 2), ("pod", "data", "model"), {"tp": False}),
    "tok4": ((1, 1, 4), ("pod", "data", "model"), {"tp": False}),
}
SEQ_B, SEQ_S, SEQ_D = 2, 8, 3


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(module: str, entry: str, arg, *, world: int = 4,
              timeout: float = RANK_TIMEOUT, env: dict | None = None) -> None:
    """``world`` processes, each calling ``module.entry(arg)`` with
    torchrun's variables set; each is waited for with its own timeout, and
    every one still running is killed when one fails."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("REPRO_", "TORCHELASTIC"))}
    base.update(PYTHONPATH=os.pathsep.join([SRC, TESTS]),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                WORLD_SIZE=str(world), OMP_NUM_THREADS="1", **(env or {}))
    code = f"import {module} as m; m.{entry}({arg!r})"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(proc.poll() is None for proc in procs):
            failed = [r for r, proc in enumerate(procs)
                      if proc.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        outs = [proc.communicate(timeout=30)[0] for proc in procs]
    for r, proc in enumerate(procs):
        assert proc.returncode == 0, f"rank {r} ({proc.returncode}, " \
            f"timeout {timeout} s):\n{outs[r][-6000:]}"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's own torch work on one thread, restored after: the
    ranks and the reference run beside it, and idle OpenMP threads
    spinning on every core would crowd the tests on the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def start_reference(code: str, *args: str, log: Path) -> subprocess.Popen:
    """``code`` in a subprocess with four forced host devices, its output
    into ``log``; :func:`finish_reference` waits for it."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with open(log, "w") as out:
        return subprocess.Popen([sys.executable, "-c", code, *args],
                                env=env, stdout=out, stderr=subprocess.STDOUT)


def finish_reference(proc: subprocess.Popen, log: Path,
                     timeout: float = 240) -> None:
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, f"the reference ({proc.returncode}, " \
        f"timeout {timeout} s):\n{Path(log).read_text()[-6000:]}"


def _inputs() -> dict[str, np.ndarray]:
    """Rank r's inputs are block r of each array (leading axis 4)."""
    rng = np.random.default_rng(0)
    e = rng.integers(0, E, size=(4, T * K))
    pos = np.zeros_like(e)
    for r in range(4):  # same-expert predecessors, in order
        for i in range(T * K):
            pos[r, i] = (e[r, :i] == e[r, i]).sum()
    scores = rng.standard_normal((2, 3, 2, 32)).astype(np.float32) * 3
    v = rng.standard_normal((2, 32, 8)).astype(np.float32)
    num, den, m = [], [], []
    for r in range(4):  # data index r // 2 (both meshes), keys r % 2's half
        s = scores[r // 2][..., (r % 2) * 16:(r % 2 + 1) * 16]
        mloc = s.max(-1)
        p = np.exp(s - mloc[..., None])
        num.append(p @ v[r // 2, (r % 2) * 16:(r % 2 + 1) * 16])
        den.append(p.sum(-1))
        m.append(mloc)
    seq = {k: rng.standard_normal((4, SEQ_B, SEQ_S, SEQ_D)).astype(
        np.float32) for k in ("seq_c", "seq_p", "seq_g")}
    return {
        **seq, "seq_x": seq["seq_c"][0] * 2,
        "x": rng.standard_normal((4, 16)).astype(np.float32),
        "buf": rng.standard_normal((4, E, CAP, D)).astype(np.float32),
        "xf": rng.standard_normal((4, T, D)).astype(np.float32),
        "e_flat": e.astype(np.int32), "pos": pos.astype(np.int32),
        "g_flat": rng.random((4, T * K)).astype(np.float32),
        "num": np.stack(num), "den": np.stack(den), "m": np.stack(m),
        "scores": scores, "v": v}


_REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.runtime import collectives as C

inp = dict(np.load(sys.argv[1]))
E, CAP = %(E)d, %(CAP)d
out = {}
for name, (shape, axes) in %(MESHES)r.items():
    mesh = jax.make_mesh(shape, axes)
    every = P(axes)

    def per_rank(f, *xs):
        def body(*a):
            r = f(*(x[0] for x in a))
            return tuple(o[None] for o in (r if isinstance(r, tuple) else (r,)))
        g = jax.shard_map(body, mesh=mesh, in_specs=(every,) * len(xs),
                          out_specs=every, check_vma=False)
        return [np.asarray(o) for o in jax.jit(g)(*xs)]

    for inner, outer in %(PMEAN_AXES)r[name]:
        out[f"{name}/pmean/{inner}/{outer}"], = per_rank(
            lambda x: C.hierarchical_pmean(x, inner, outer), inp["x"])
    out[f"{name}/a2a"], = per_rank(
        lambda b: C.all_to_all_experts(b, "model"), inp["buf"])
    out[f"{name}/combine"], = per_rank(
        lambda b: C.all_to_all_combine(C.all_to_all_experts(b, "model"),
                                       "model", E), inp["buf"])
    out[f"{name}/flash"], = per_rank(
        lambda n, d, m: C.flash_decode_psum(n, d, m, "model"),
        inp["num"], inp["den"], inp["m"])
    out[f"{name}/dispatch"], = per_rank(
        lambda xf, e, g, pos: C.shard_map_moe_dispatch(
            xf, e, g, pos < CAP, pos, CAP, "model", E),
        inp["xf"], inp["e_flat"], inp["g_flat"], inp["pos"])
np.savez(sys.argv[2], **out)
print("OK")
"""


def collectives_worker(directory: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import collectives as C

    dist.init_process_group("gloo")
    r = dist.get_rank()
    inp = {k: torch.from_numpy(v[r]) for k, v in
           np.load(Path(directory) / "inputs.npz").items()
           if k not in ("scores", "v", "seq_x")}
    seq_x = torch.from_numpy(np.load(Path(directory) / "inputs.npz")[
        "seq_x"])
    out = {}
    for name, (shape, axes) in MESHES.items():
        mesh = make_mesh(shape, axes, device="cpu")
        for inner, outer in PMEAN_AXES[name]:
            out[f"{name}/pmean/{inner}/{outer}"] = C.hierarchical_pmean(
                inp["x"], inner, outer, mesh)
        a2a = C.all_to_all_experts(inp["buf"], "model", mesh)
        out[f"{name}/a2a"] = a2a
        out[f"{name}/combine"] = C.all_to_all_combine(a2a, "model", E, mesh)
        out[f"{name}/flash"] = C.flash_decode_psum(
            inp["num"], inp["den"], inp["m"], "model", mesh)
        e, pos = inp["e_flat"].long(), inp["pos"].long()
        out[f"{name}/dispatch"] = C.shard_map_moe_dispatch(
            inp["xf"], e, inp["g_flat"], pos < CAP, pos, CAP, "model", E,
            mesh)
        # the gradient-carrying reductions, over "model" and the data axes
        model = C.axis_groups(mesh, "model")
        data = C.axis_groups(mesh, [a for a in axes if a != "model"])
        x = inp["x"].clone().requires_grad_(True)
        y = C.psum(x, model) + C.pmean(x, data) + C.psum(x, data,
                                                          grad_scale=3)
        z = C.replicated(x, model)
        (g_y,) = torch.autograd.grad((y * inp["x"]).sum(), x)
        (g_z,) = torch.autograd.grad((z * inp["x"]).sum(), x)
        out[f"{name}/reductions"] = y.detach()
        out[f"{name}/grad_y"], out[f"{name}/grad_z"] = g_y, g_z
    out.update(_seq_collectives(seq_x, inp))
    torch.save({k: v.numpy() for k, v in out.items()},
               Path(directory) / f"rank{r}.pt")
    dist.destroy_process_group()


def _seq_collectives(x, inp) -> dict:
    """This rank's outputs and input gradients of the sequence's
    collectives on each of ``SEQ_MESHES``: ``x`` the whole (B, S, D)
    stream, every rank's; the cotangents ``seq_c`` (of whole-sequence
    outputs) and ``seq_g`` (this rank's positions of it), the partials
    ``seq_p``, this rank's."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import partition as pt
    from repro_torch.runtime.sharding import (fresh_report, train_rules,
                                              use_rules)
    out = {}
    for name, (shape, axes, kw) in SEQ_MESHES.items():
        mesh = make_mesh(shape, axes, device="cpu")
        with use_rules(train_rules(len(axes) == 3, **kw), mesh):
            with fresh_report() as report:  # a length that does not divide
                whole = pt.stream_axis(SEQ_S + 1)
            out[f"{name}/fallback"] = torch.tensor([whole.n, report == {
                "activations": [f"axis 'seq' dim {SEQ_S + 1} not divisible "
                                f"by ('model',)={shape[-1]}; replicated"]}])
            sq = pt.stream_axis(SEQ_S)
            lo, hi = sq.block(SEQ_S)
            block = x[:, lo:hi]
            cot = inp["seq_g"][:, lo:hi]
            cases = {"seq_gather": (lambda t: pt.seq_gather(t, sq), block,
                                    inp["seq_c"]),
                     "seq_scatter": (lambda t: pt.seq_scatter(t, sq), x,
                                     cot)}
            if pt.model_axis() is not None:  # a region's boundaries
                ax = pt.tp_axis(1, sq.n, sq)
                cases["enter"] = (lambda t: pt.enter(t, ax), block,
                                  inp["seq_c"])
                cases["leave"] = (lambda t: pt.leave(t, ax), inp["seq_p"],
                                  cot)
            for case, (fn, t, c) in cases.items():
                t = t.clone().requires_grad_(True)
                y = fn(t)
                (g,) = torch.autograd.grad(y, t, c)
                out[f"{name}/{case}"], out[f"{name}/{case}_grad"] = \
                    y.detach(), g
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    reference = start_reference(
        _REFERENCE % {"E": E, "CAP": CAP, "MESHES": MESHES,
                      "PMEAN_AXES": PMEAN_AXES},
        str(tmp / "inputs.npz"), str(tmp / "ref.npz"), log=tmp / "ref.log")
    try:
        run_ranks("test_torch_collectives", "collectives_worker", str(tmp))
    finally:
        finish_reference(reference, tmp / "ref.log")
    ref = dict(np.load(tmp / "ref.npz"))
    port = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    return inp, ref, port


KEYS = [(m, f"pmean/{i}/{o}") for m in MESHES for i, o in PMEAN_AXES[m]] + [
    (m, k) for m in MESHES for k in ("a2a", "combine", "flash", "dispatch")]


@pytest.mark.parametrize("mesh,key", KEYS, ids=[f"{m}-{k}" for m, k in KEYS])
def test_collective_matches_reference(results, mesh, key):
    _, ref, port = results
    want = ref[f"{mesh}/{key}"]
    for r in range(4):
        got = port[r][f"{mesh}/{key}"]
        assert got.shape == want[r].shape, (r, got.shape, want[r].shape)
        if key in ("a2a", "combine", "dispatch"):
            assert np.array_equal(got, want[r]), (mesh, key, r)
        else:
            np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_all_to_all_round_trip_is_identity(results, mesh):
    inp, _, port = results
    for r in range(4):
        assert np.array_equal(port[r][f"{mesh}/combine"], inp["buf"][r])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_flash_decode_psum_is_the_unsharded_softmax(results, mesh):
    inp, _, port = results
    for r in range(4):
        s, v = inp["scores"][r // 2], inp["v"][r // 2]
        p = np.exp(s - s.max(-1, keepdims=True))
        want = (p / p.sum(-1, keepdims=True)) @ v
        np.testing.assert_allclose(port[r][f"{mesh}/flash"], want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_hierarchical_pmean_is_the_data_mean(results, mesh):
    """The trainer's mean (inner "data", outer "pod" where there is one):
    the mean of the ranks that share a "model" coordinate."""
    inp, _, port = results
    inner, outer = PMEAN_AXES[mesh][0]
    for r in range(4):
        want = inp["x"][[r % 2, r % 2 + 2]].mean(0)
        np.testing.assert_allclose(
            port[r][f"{mesh}/pmean/{inner}/{outer}"], want, rtol=1e-6)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradient_carrying_reductions(results, mesh):
    """``psum`` and ``pmean`` pass the cotangent through (``psum`` times its
    ``grad_scale``), ``replicated`` sums it over the group; forward, they
    are the sum, the mean and the identity."""
    inp, _, port = results
    x = inp["x"]
    for r in range(4):
        mates = [r ^ 1]                      # the other "model" rank
        data = [r % 2 + 2 if r < 2 else r % 2]  # the other data rank
        want = (x[r] + x[mates[0]]) + (x[r] + x[data[0]]) / 2 \
            + (x[r] + x[data[0]])
        np.testing.assert_allclose(port[r][f"{mesh}/reductions"], want,
                                   rtol=1e-6)
        np.testing.assert_allclose(port[r][f"{mesh}/grad_y"], x[r] * 5,
                                   rtol=1e-6)
        np.testing.assert_allclose(port[r][f"{mesh}/grad_z"],
                                   x[r] + x[mates[0]], rtol=1e-6)


def _seq_ranks(name: str, r: int) -> tuple[int, list[int], slice]:
    """Rank r's coordinate on the model axis of ``SEQ_MESHES[name]``, the
    ranks of its model group in model order, and its block of the
    positions."""
    n = SEQ_MESHES[name][0][-1]
    j, size = r % n, SEQ_S // n
    return j, [r - j + i for i in range(n)], slice(j * size,
                                                   (j + 1) * size)


SEQ_CASES = [(m, c) for m in SEQ_MESHES for c in
             ("seq_gather", "seq_scatter")
             + (("enter", "leave") if m.startswith("sp") else ())]


@pytest.mark.parametrize("mesh,case", SEQ_CASES,
                         ids=[f"{m}-{c}" for m, c in SEQ_CASES])
def test_sequence_collectives(results, mesh, case):
    """Forward and backward of the sequence's collectives against the
    reckoning from every rank's inputs: a region's ``enter`` all-gathers
    the positions (backward: the sum of the group's cotangents, this
    rank's positions) and ``leave`` reduce-scatters the group's partials
    (backward: the all-gather of the positions' cotangents);
    ``seq_gather`` all-gathers them, its backward this rank's positions of
    its own cotangent under sequence parallelism (a replicated
    computation's) and the sum's under token parallelism (each rank's
    part); ``seq_scatter`` keeps this rank's positions, its backward the
    all-gather of the ranks' cotangents under sequence parallelism and
    its own in place, zeros elsewhere, under token parallelism."""
    inp, _, port = results
    x, c, p, g = (inp[k] for k in ("seq_x", "seq_c", "seq_p", "seq_g"))
    sp = mesh.startswith("sp")
    for r in range(4):
        j, group, blk = _seq_ranks(mesh, r)
        gathered = np.concatenate(
            [g[i][:, _seq_ranks(mesh, i)[2]] for i in group], axis=1)
        if case in ("enter", "seq_gather"):
            want = x
            if case == "seq_gather" and sp:
                want_grad = c[r][:, blk]
            else:
                want_grad = sum(c[i] for i in group)[:, blk]
        elif case == "leave":
            want, want_grad = sum(p[i] for i in group)[:, blk], gathered
        else:  # seq_scatter
            want = x[:, blk]
            if sp:
                want_grad = gathered
            else:
                want_grad = np.zeros_like(x)
                want_grad[:, blk] = g[r][:, blk]
        got = port[r][f"{mesh}/{case}"]
        assert got.shape == want.shape, (r, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(port[r][f"{mesh}/{case}_grad"],
                                   want_grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mesh", list(SEQ_MESHES))
def test_sequence_divisibility_fallback(results, mesh):
    """A stream whose length does not divide by the model axis stays whole
    (``stream_axis`` is ``UNIT``) and the report says so, as
    ``logical_to_spec``'s fallback."""
    _, _, port = results
    for r in range(4):
        assert port[r][f"{mesh}/fallback"].tolist() == [1, 1]
