"""Serving under ``serve_rules`` on four CPU processes: prefill and decode
on each rank's block of the weights, the cache and the batch, held to one
process and to the JAX package's partitioned prefill and decode step.

Four gloo ranks (``RANK``/``WORLD_SIZE``/``MASTER_*`` set as
``torch.distributed.run`` sets them) build the production mesh at a (2, 2)
``("data", "model")`` shape (``REPRO_MESH_OVERRIDE=2x2``) and a (2, 1, 2)
``("pod", "data", "model")`` one (``2x1x2``, the multi-pod rules), and
serve each arch of the mesh (``RUNS``) in one set of processes under the
dry-run's rules for it (``dryrun.serving_rules``: ``serve_rules`` with the
arch's ``KV_SHARD`` layout, ``/wsharded`` for deepseek-v2): gemma-7b's
cache split over its kv heads, the others' over its positions.  Each rank
takes its ``explicit_spec`` block of the cast parameters, of a zero cache
of ``CACHE_LEN`` positions and of the prompt's rows, prefills a
``PROMPT``-token prompt (not a multiple of the tail's 8) and runs
``STEPS`` greedy decode steps, each after ``merge_tail``: the run crosses
two tail merges (the first straddles the two model ranks' blocks of 20
positions) and the ring's wrap at 32 (recurrentgemma's window).  Tokens
come from the logits gathered over "model", so every rank takes the same
argmax.  The smoke configs, in float32 (float32 caches; the MoE's capacity
factor E/k, so that no assignment drops) and in bf16 (its own caches):

* float32: the logits (the ranks' vocabulary blocks put together) of the
  prefill and of every step equal one process's ``make_prefill_fn`` /
  ``make_decode_fn`` at 1e-5 relative, the tokens are equal, and the final
  cache's blocks, put together, equal the single process's cache at 1e-5;
* bf16, every step of either run on the float32 run's tokens: the
  prefill's logits within 2e-2 of the single process's, every step's
  within 3e-2;
* each rank's parameters and cache hold exactly their ``logical_to_spec``
  blocks, and no mapping of the rules is recorded as not applied;
* the first prefill's and decode step's logits equal the JAX package's
  ``make_prefill_fn``/``make_decode_fn`` jitted under the same rules on a
  mesh of four forced host devices (``Auto`` axes) with the dry-run's in-
  and out-shardings, from the same parameters and prompt, at 1e-5
  (``REFERENCE_RUNS``), run in a subprocess beside the ranks.
"""

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_collectives import (MESHES, finish_reference,  # noqa: F401
                                    one_thread, run_ranks, start_reference)

RUNS = {
    "2x2": ("gemma-7b", "internlm2-1.8b", "recurrentgemma-2b", "mamba2-2.7b",
            "deepseek-v2-236b", "whisper-base"),
    "2x1x2": ("internlm2-1.8b", "deepseek-v2-236b"),
}
REFERENCE_RUNS = {
    "2x2": ("internlm2-1.8b", "gemma-7b", "mamba2-2.7b", "recurrentgemma-2b"),
    "2x1x2": ("internlm2-1.8b", "deepseek-v2-236b"),
}
DTYPES = ("float32", "bfloat16")
BATCH, PROMPT, STEPS, CACHE_LEN = 4, 23, 13, 40
TOL, BF16_TOL, BF16_STEP_TOL = 1e-5, 2e-2, 3e-2


def config(arch: str, dtype: str):
    """The test's smoke config: ``dtype`` activations and parameters (bf16
    keeps the config's own parameter dtype), the MoE's capacity factor
    E/k."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True)
    if dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def inputs(cfg) -> dict[str, np.ndarray]:
    """The prompt (and Whisper's frames) from a fixed seed."""
    rng = np.random.default_rng(7)
    out = {"inputs": rng.integers(0, cfg.vocab, size=(BATCH, PROMPT)).astype(
        np.int32)}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """``chip_smoke.py`` as a module (its ``greedy_serve``)."""
    from test_torch_collectives import ROOT
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def serve(arch: str, dtype: str, mesh=None, rules=None, forced=None) -> dict:
    """Prefill and ``STEPS`` decode steps of ``arch`` in ``dtype`` on this
    process (``chip_smoke.greedy_serve``): the whole model without
    ``mesh``, else this rank's blocks under ``use_rules(rules, mesh)``;
    greedy, or on ``forced``'s (rows, STEPS) tokens.  Returns the logits
    of each call (this rank's block), the tokens, the final cache and the
    shapes held."""
    from repro_torch.models import (cast_params, init_cache_specs,
                                    init_params, param_specs)
    from repro_torch.runtime.sharding import (NamedSharding, explicit_spec,
                                              use_rules)
    cfg = config(arch, dtype)
    enc_len = cfg.enc_seq if cfg.is_encdec else 0
    specs = param_specs(cfg)
    cspecs = init_cache_specs(cfg, BATCH, CACHE_LEN, enc_len)

    def block(axes, t, context):
        if mesh is None:
            return t
        spec = explicit_spec(axes, t.shape, rules, mesh, context)
        return NamedSharding(mesh, spec).local_slice(t).clone()

    params = cast_params(cfg, init_params(specs, 0, device="cpu"))
    params = {k: block(specs[k].axes, v, k) for k, v in params.items()}
    cache = {k: block(s.axes, torch.zeros(s.shape, dtype=getattr(
        torch, s.dtype if dtype != "float32" else "float32")), k)
        for k, s in cspecs.items()}
    raw = inputs(cfg)
    batch = {"inputs": block(("batch", None), torch.from_numpy(
        raw["inputs"]).long(), "inputs")}
    if "frames" in raw:
        batch["frames"] = block(("batch", None, None),
                                torch.from_numpy(raw["frames"]), "frames")
    rec = {"held": {"params": {k: tuple(v.shape) for k, v in params.items()},
                    "cache": {k: tuple(v.shape) for k, v in cache.items()}}}
    with use_rules(rules, mesh):
        run = _chip_smoke().greedy_serve(
            cfg, params, batch, cache, steps=STEPS, cache_len=CACHE_LEN,
            enc_len=enc_len, forced=forced)
    rec["logits"] = [t.float() for t in run["logits"]]
    rec["tokens"] = run["tokens"]
    rec["cache"] = {k: v.float().clone() for k, v in cache.items()}
    return rec


def forcing(rec) -> torch.Tensor:
    """The (rows, STEPS) tokens of a float32 run, to force a bf16 run's
    steps with: the same inputs on either side of a comparison."""
    return torch.cat(rec["tokens"][:STEPS], 1)


def serve_worker(arg) -> None:
    """One rank: every run of its mesh, both dtypes, then its records and
    the sharding report into ``<directory>/rank<r>.pt``."""
    directory, mesh_name = arg
    import torch.distributed as dist

    from repro_torch.launch.dryrun import serving_rules
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import fresh_report
    dist.init_process_group("gloo")
    multi_pod = len(MESHES[mesh_name][1]) == 3
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    out = {}
    for arch in RUNS[mesh_name]:
        rules = serving_rules(arch, multi_pod)
        with fresh_report() as report:
            out[arch, "float32"] = f32 = serve(arch, "float32", mesh, rules)
            out[arch, "bfloat16"] = serve(arch, "bfloat16", mesh, rules,
                                          forced=forcing(f32))
        out[arch, "report"] = {k: list(v) for k, v in report.items()}
    torch.save(out, Path(directory) / f"rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


# the JAX package's prefill and one greedy decode step under the dry-run's
# rules on a mesh of four host devices (Auto axes: jax 0.9's make_mesh
# makes Explicit ones, which the reference's shard() refuses), jitted with
# the dry-run's in- and out-shardings, from the port's parameters, prompt
# and a float32 zero cache (npz keys "<arch>/params/<name>",
# "<arch>/inputs/<name>")
_REFERENCE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import (init_cache_specs, make_decode_fn, make_prefill_fn,
                          param_specs)
from repro.runtime.sharding import (ShardingRules, named_sharding,
                                    serve_rules, use_rules)

shape, axes, runs, kv_shard, offload, B, T = %(args)r
inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
out = {}
for arch in runs:
    rules = serve_rules(len(axes) == 3, kv_shard=kv_shard[arch])
    if arch in offload:
        r = dict(rules.rules)
        r["fsdp"] = ("data",)
        rules = ShardingRules(r, name=rules.name + "/wsharded")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              param_dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)

    def part(kind):
        head = f"{arch}/{kind}/"
        return {k[len(head):]: jnp.asarray(v) for k, v in inp.items()
                if k.startswith(head)}
    params, batch = part("params"), part("inputs")
    enc = cfg.enc_seq if cfg.is_encdec else 0
    cspecs = init_cache_specs(cfg, B, T, enc)
    cache = {k: jnp.zeros(s.shape, jnp.float32) for k, s in cspecs.items()}

    def sh(specs):
        return {k: named_sharding(s.axes, s.shape, rules, mesh)
                for k, s in specs.items()}
    p_sh, c_sh = sh(param_specs(cfg)), sh(cspecs)
    b_sh = {k: named_sharding(("batch",) + (None,) * (v.ndim - 1), v.shape,
                              rules, mesh) for k, v in batch.items()}
    logits_sh = named_sharding(("batch", None, "vocab"), (B, 1, cfg.vocab),
                               rules, mesh)
    tok_sh = named_sharding(("batch", None), (B, 1), rules, mesh)
    rep = NamedSharding(mesh, P())
    with use_rules(rules, mesh):
        prefill = jax.jit(make_prefill_fn(cfg), in_shardings=(
            p_sh, b_sh, c_sh), out_shardings=(logits_sh, c_sh))
        logits, cache = prefill(params, batch, cache)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        decode = jax.jit(make_decode_fn(cfg), in_shardings=(
            p_sh, c_sh, tok_sh, rep), out_shardings=(logits_sh, c_sh))
        pos = jnp.int32(batch["inputs"].shape[1])
        logits2, _ = decode(params, cache, tok, pos)
    out[f"{arch}/prefill"] = np.asarray(logits)
    out[f"{arch}/token"] = np.asarray(tok)
    out[f"{arch}/decode"] = np.asarray(logits2)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(mesh)``: the mesh's runs, served once each in this module,
    the ranks' records and the JAX package's first steps."""
    done: dict = {}

    def get(mesh: str):
        if mesh not in done:
            done[mesh] = _serve_mesh(mesh, tmp_path_factory)
        return done[mesh]
    return get


def _serve_mesh(mesh: str, tmp_path_factory):
    from repro_torch.configs import OFFLOAD_ARCHS
    from repro_torch.launch.dryrun import KV_SHARD
    from repro_torch.models import init_params, param_specs
    tmp = tmp_path_factory.mktemp(f"mesh_serve_{mesh}")
    inp = {}
    for arch in REFERENCE_RUNS[mesh]:
        cfg = config(arch, "float32")
        inp.update({f"{arch}/params/{k}": v.numpy() for k, v in init_params(
            param_specs(cfg), 0, device="cpu").items()})
        inp.update({f"{arch}/inputs/{k}": v for k, v in inputs(cfg).items()})
    np.savez(tmp / "inputs.npz", **inp)
    shape, axes = MESHES[mesh]
    runs = REFERENCE_RUNS[mesh]
    reference = start_reference(
        _REFERENCE % {"args": (shape, axes, runs, dict(KV_SHARD),
                               tuple(OFFLOAD_ARCHS), BATCH, CACHE_LEN)},
        str(tmp / "inputs.npz"), str(tmp / "ref.npz"), log=tmp / "ref.log")
    try:
        run_ranks("test_torch_mesh_serve", "serve_worker", (str(tmp), mesh),
                  env={"REPRO_MESH_OVERRIDE": mesh}, timeout=300)
    finally:
        finish_reference(reference, tmp / "ref.log", timeout=400)
    return ([torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(4)], dict(np.load(tmp / "ref.npz")))


@pytest.fixture(scope="module")
def single():
    """One process's run of each (arch, dtype), made once."""
    done: dict = {}

    def get(arch: str, dtype: str):
        if (arch, dtype) not in done:
            done[arch, dtype] = serve(arch, dtype, forced=None if dtype ==
                                      "float32" else forcing(get(
                                          arch, "float32")))
        return done[arch, dtype]
    return get


def _coords(mesh: str, rank: int) -> dict[str, int]:
    shape, axes = MESHES[mesh]
    out = {}
    for a, n in zip(reversed(axes), reversed(shape)):
        out[a], rank = rank % n, rank // n
    return out


def _shardings(mesh: str, arch: str, dtype: str) -> dict:
    """(full shape, ``NamedSharding`` under ``logical_to_spec``) of every
    parameter ("param/<name>"), cache entry ("cache/<name>") and the
    logits, on a shape-only mesh under the arch's serving rules."""
    from repro_torch.launch.dryrun import serving_rules
    from repro_torch.models import init_cache_specs, param_specs
    from repro_torch.runtime.sharding import NamedSharding, logical_to_spec
    shape, axes = MESHES[mesh]
    m = SimpleNamespace(shape=dict(zip(axes, shape)))
    rules = serving_rules(arch, len(axes) == 3)
    cfg = config(arch, dtype)
    enc = cfg.enc_seq if cfg.is_encdec else 0
    entries = {f"param/{k}": (s.axes, s.shape)
               for k, s in param_specs(cfg).items()}
    entries.update({f"cache/{k}": (s.axes, s.shape) for k, s in
                    init_cache_specs(cfg, BATCH, CACHE_LEN, enc).items()})
    entries["logits"] = (("batch", None, "vocab"), (BATCH, 1, cfg.vocab))
    return {k: (shp, NamedSharding(m, logical_to_spec(axes_, shp, rules, m)))
            for k, (axes_, shp) in entries.items()}


def _assembled(mesh: str, blocks: list, sh, shape) -> torch.Tensor:
    """The ranks' blocks put in their places; a block that several ranks
    hold must be the same on each."""
    whole = torch.full(shape, float("nan"))
    for r, blk in enumerate(blocks):
        sh.local_slice(whole, _coords(mesh, r)).copy_(blk)
    for r, blk in enumerate(blocks):
        assert torch.equal(sh.local_slice(whole, _coords(mesh, r)), blk), r
    return whole


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / max(1e-12, float(b.abs().max())))


CASES = [(mesh, arch) for mesh in RUNS for arch in RUNS[mesh]]
IDS = [f"{m}-{a}" for m, a in CASES]


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_mesh_serving_matches_single_process(ranks, single, mesh, arch):
    """float32: every call's logits at 1e-5, the greedy tokens equal, the
    final cache's blocks put together at 1e-5."""
    results, _ = ranks(mesh)
    want = single(arch, "float32")
    sh = _shardings(mesh, arch, "float32")
    shape, logits_sh = sh["logits"]
    for i, w in enumerate(want["logits"]):
        got = _assembled(mesh, [r[arch, "float32"]["logits"][i]
                                for r in results], logits_sh, shape)
        assert _rel(got, w) < TOL, (i, _rel(got, w))
    for rec in results:
        assert [t.tolist() for t in rec[arch, "float32"]["tokens"]] == [
            t[_rows(mesh, rec, results)].tolist() for t in want["tokens"]]
    for name, w in want["cache"].items():
        shape, csh = sh[f"cache/{name}"]
        got = _assembled(mesh, [r[arch, "float32"]["cache"][name]
                                for r in results], csh, shape)
        assert _rel(got, w) < TOL, (name, _rel(got, w))


def _rows(mesh: str, rec, results) -> slice:
    """The batch rows of a rank's records (its block over the batch axes,
    found by its position in ``results``)."""
    r = next(i for i, x in enumerate(results) if x is rec)
    c = _coords(mesh, r)
    i = c.get("pod", 0) * MESHES[mesh][0][-2] + c["data"]
    n = BATCH // 2  # two batch blocks on either mesh
    return slice(i * n, (i + 1) * n)


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_mesh_serving_bf16_within_two_percent(ranks, single, mesh, arch):
    """bf16 (its own caches), the steps of both runs forced with the
    float32 run's tokens (the same inputs on either side): the prefill's
    logits within BF16_TOL (2e-2) of one process's, relative to their
    largest, and each step's within BF16_STEP_TOL (3e-2).  The row-parallel
    sums round each rank's part to bf16 once more: sound steps read up to
    2.34e-2 here (one process's own bf16 reads up to 4.9e-2 against
    float32), while a combine that counts the tail on every rank reads
    7.7e-2 to 1.56 and one that drops the other ranks' partials 0.73 to
    2.03 (PERF.md)."""
    results, _ = ranks(mesh)
    want = single(arch, "bfloat16")
    shape, sh = _shardings(mesh, arch, "bfloat16")["logits"]
    errs = [_rel(_assembled(mesh, [r[arch, "bfloat16"]["logits"][i]
                                   for r in results], sh, shape), w)
            for i, w in enumerate(want["logits"])]
    assert len(errs) == STEPS + 1
    assert errs[0] < BF16_TOL and max(errs[1:]) < BF16_STEP_TOL, errs


@pytest.mark.parametrize("mesh,arch", CASES, ids=IDS)
def test_mesh_serving_holds_its_blocks(ranks, mesh, arch):
    """Each rank's parameters and cache have its ``logical_to_spec``
    blocks' shapes, in both dtypes, and its report records no mapping as
    not applied."""
    results, _ = ranks(mesh)
    for dtype in DTYPES:
        sh = _shardings(mesh, arch, dtype)
        for rec in results:
            held = rec[arch, dtype]["held"]
            for kind in ("params", "cache"):
                for name, got in held[kind].items():
                    shape, s = sh[f"{kind[:5]}/{name}"]
                    assert got == s.shard_shape(shape), (kind, name, got)
    for rec in results:
        assert "not applied" not in json.dumps(rec[arch, "report"])


REF_CASES = [(mesh, arch) for mesh in REFERENCE_RUNS
             for arch in REFERENCE_RUNS[mesh]]


@pytest.mark.parametrize("mesh,arch", REF_CASES,
                         ids=[f"{m}-{a}" for m, a in REF_CASES])
def test_mesh_serving_matches_reference(ranks, mesh, arch):
    """The first prefill's and decode step's logits against the JAX
    package's partitioned ones at 1e-5, and the same greedy token."""
    results, ref = ranks(mesh)
    shape, sh = _shardings(mesh, arch, "float32")["logits"]
    for i, key in enumerate(("prefill", "decode")):
        got = _assembled(mesh, [r[arch, "float32"]["logits"][i]
                                for r in results], sh, shape)
        want = torch.from_numpy(ref[f"{arch}/{key}"]).float()
        assert _rel(got, want) < TOL, (key, _rel(got, want))
    tok = torch.cat([r[arch, "float32"]["tokens"][0] for r in results[::2]])
    assert tok.tolist() == ref[f"{arch}/token"].tolist()


def test_mesh_serving_phase_at_smoke_widths():
    """``chip_smoke.py`` phase 9m (a)'s serving-rules routine on the CPU at
    the smoke config: prefill and 12 greedy steps across two tail merges,
    plainly and under the arch's serving rules on a one-rank gloo mesh,
    bit-equal; the group is destroyed after."""
    import torch.distributed as dist
    out = _chip_smoke().mesh_serving("cpu", smoke=True)
    assert out["logits_equal"] and out["tokens_equal"]
    assert out["tail_merges"] == 2 and out["steps"] == 12
    assert not dist.is_initialized()
