"""The port's dry-run and cost model (``repro_torch.launch.dryrun``,
``repro_torch.perf``) against the reference's, on the CPU.

The reference runs in one subprocess (``REFERENCE``): the analytic state
bytes of every (arch x shape x mesh) cell on the production meshes (16x16,
2x16x16) and the override meshes 2x4 and 2x2x2, and ``analyze_hlo`` of
four cells compiled on the 8x1 override mesh with ``_ELEMENTWISE`` emptied
(in that subprocess only), so that it counts products and reductions.
Its meshes are built with ``Auto`` axes: jax 0.9's ``make_mesh`` makes
``Explicit`` ones, which ``shard``'s ``with_sharding_constraint`` refuses
(``src/repro/runtime/sharding.py:175``, first reached from ``_embed``) --
the cause of the reference's four failing ``test_mini_dryrun_cell``
cases.  Nothing in ``src/repro`` changes.

The port's fake process groups live inside :func:`fake_world`, which
destroys them on exit; its CLI runs in subprocesses.

Product FLOPs per device on the 8x1 mesh, port / reference (the port's
counter without its elementwise and reduction terms; the reference's
``analyze_hlo`` without its elementwise ones), when this file was written:
mamba2-2.7b train_4k 2.92972e15 / 2.93101e15 (0.9996), internlm2-1.8b
decode_32k 1.57865e11 / 1.58284e11 (0.9974), mamba2-2.7b long_500k
5.48458e9 / 5.48509e9 (0.9999); internlm2-1.8b prefill_32k with attention
taken out of both (B3's charges; every tile of the reference's scan)
3.95826e14 / 3.99241e14 (0.9914).  What is left is mostly the reductions
the reference's side keeps: its attention scan reduces each (head, pair)
twice, 3.3e12 a device at prefill_32k.  The reference's scan computes every
(q block, kv block) tile, masked or not (``src/repro/models/attention.py
:91-92``); the port's ``blockwise_attention`` stops at the causal edge
and B3 does the causal pairs only, so whole steps with attention differ
and attention is compared term by term.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, Shape, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.perf import OpCounter, extrapolate
from repro_torch.runtime.sharding import serve_rules, train_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

PAIRS = (((16, 16), (2, 16, 16)), ((2, 4), (2, 2, 2)))
FLOP_CELLS = {  # cell: (bound on |port / reference - 1|)
    ("mamba2-2.7b", "train_4k"): 0.01,
    ("internlm2-1.8b", "decode_32k"): 0.01,
    ("mamba2-2.7b", "long_500k"): 0.01,
    ("internlm2-1.8b", "prefill_32k"): 0.02,  # attention taken out
}
# a training cell with causal attention, whose step is compared whole
ATTENTION_CELL = ("internlm2-1.8b", "train_4k")
MINI_CELLS = [("internlm2-1.8b", "train_4k", False),
              ("internlm2-1.8b", "decode_32k", False),
              ("mamba2-2.7b", "long_500k", False),
              ("internlm2-1.8b", "train_4k", True),
              ("qwen2-72b", "long_500k", False)]  # the skip rule
# the TRAIN_NO_TP archs' train_4k on the 2x2x2 override (multi-pod
# tp=False: the sequence over "model"), compiled by the reference too
NO_TP_CELLS = ("internlm2-1.8b", "whisper-base")
# more cells through the port's CLI: (arch, shape, multi_pod, tag) -> its
# extra arguments
CLI_CELLS = {(a, s, mp, ""): [] for a, s, mp in MINI_CELLS}
CLI_CELLS.update({
    ("whisper-base", "train_4k", True, ""): [],
    ("internlm2-20b", "train_4k", False, "sp"): ["--seq-shard"],
})

_REFERENCE = r'''
import json, os, sys
os.environ.pop("REPRO_DRYRUN_DEVICES", None)
import repro.launch.dryrun as rd  # sets XLA_FLAGS (512 devices) before jax
import jax
import numpy as np
from jax.sharding import AxisType, Mesh
import repro.perf.hlo_analysis as ha
from repro.configs import ARCHS, SHAPES
from repro.runtime.sharding import use_rules

MESH = {}

def make_production_mesh(multi_pod=False):
    shape = MESH[multi_pod]
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, axes, axis_types=(AxisType.Auto,) * len(axes))

rd.make_production_mesh = make_production_mesh
out = {"state": {}, "flops": {}}
for pair in PAIRS:
    MESH[False], MESH[True] = pair
    for mp in (False, True):
        for a in sorted(ARCHS):
            for s in sorted(SHAPES):
                key = "x".join(map(str, MESH[mp])) + f"/{a}/{s}"
                try:
                    step, args, in_sh, out_sh, rules, mesh, meta = \
                        rd.build_cell(a, s, multi_pod=mp)
                except rd.SkipCell as e:
                    out["state"][key] = {"status": "skip", "reason": str(e)}
                    continue
                out["state"][key] = {
                    "status": "ok", **meta,
                    "n_devices": int(np.prod(mesh.devices.shape)),
                    "state_bytes_per_device":
                        rd._analytic_state_bytes(in_sh, args)}
ha._ELEMENTWISE.clear()  # products and reductions only
MESH[False] = (8, 1)
for a, s in FLOP_CELLS:
    step, args, in_sh, out_sh, rules, mesh, meta = rd.build_cell(
        a, s, multi_pod=False)
    with use_rules(rules, mesh), mesh:
        c = jax.jit(step, in_shardings=in_sh,
                    out_shardings=out_sh).lower(*args).compile()
    out["flops"][f"{a}/{s}"] = ha.analyze_hlo(c.as_text()).flops
MESH[True] = (2, 2, 2)
out["no_tp"] = {}
for a in NO_TP_CELLS:
    step, args, in_sh, out_sh, rules, mesh, meta = rd.build_cell(
        a, "train_4k", multi_pod=True)
    with use_rules(rules, mesh), mesh:
        c = jax.jit(step, in_shardings=in_sh,
                    out_shardings=out_sh).lower(*args).compile()
    out["no_tp"][a] = {"flops": ha.analyze_hlo(c.as_text()).flops,
                       "temp": c.memory_analysis().temp_size_in_bytes}
print(json.dumps(out))
'''


class _Background:
    """The reference's subprocess and the port's CLI on the reference's
    mini cells, started together, each read once."""

    def __init__(self, tmp):
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
        cells = list(FLOP_CELLS) + [ATTENTION_CELL]
        code = (f"PAIRS = {PAIRS!r}\nFLOP_CELLS = {cells!r}\n"
                f"NO_TP_CELLS = {NO_TP_CELLS!r}\n" + _REFERENCE)
        self.ref = subprocess.Popen([sys.executable, "-c", code], env=env,
                                    cwd=REPO, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        self.cli = {}
        for (arch, shape, mp, tag), extra in CLI_CELLS.items():
            out = os.path.join(tmp, f"{arch}_{shape}_{mp}_{tag}")
            cenv = dict(env, REPRO_DRYRUN_DEVICES="8",
                        REPRO_MESH_OVERRIDE="2x2x2" if mp else "2x4")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", out, *extra]
            if mp:
                cmd.append("--multi-pod")
            self.cli[(arch, shape, mp, tag)] = (out, subprocess.Popen(
                cmd, env=cenv, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        self._ref = None

    def reference(self) -> dict:
        if self._ref is None:
            out, err = self.ref.communicate(timeout=300)
            assert self.ref.returncode == 0, err[-3000:]
            self._ref = json.loads(out.strip().splitlines()[-1])
        return self._ref

    def record(self, arch, shape, mp, tag="") -> dict:
        out, proc = self.cli[(arch, shape, mp, tag)]
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        mesh = "pod2x16x16" if mp else "pod16x16"
        with open(os.path.join(out, mesh, f"{arch}__{shape}.json")) as f:
            return json.load(f)

    def close(self):
        for p in [self.ref] + [p for _, p in self.cli.values()]:
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    bg = _Background(str(tmp_path_factory.mktemp("dryrun")))
    yield bg
    bg.close()


@pytest.fixture
def override(monkeypatch):
    """Set REPRO_MESH_OVERRIDE for the port's mesh factory."""
    return lambda shape: monkeypatch.setenv(
        "REPRO_MESH_OVERRIDE", "x".join(map(str, shape)))


def _smoke(arch, **loops):
    cfg = get_config(arch, smoke=True)
    return dr.at_depth(cfg, {**dr.depth_loops(cfg), **loops})


# -- the analyzer: the reference's analyzer tests, mirrored --------------------

def test_analyzer_matches_reference_on_scan_gradient():
    """12 steps of tanh(c @ w) and the gradient: the port's eager program
    counted on meta tensors within 5% of ``analyze_hlo`` of the
    reference's scan."""
    import jax
    import jax.numpy as jnp
    from repro.perf import analyze_hlo

    def scan_f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=12)
        return y.sum()

    s = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    want = analyze_hlo(jax.jit(jax.grad(scan_f)).lower(s, s).compile()
                       .as_text()).flops
    x = torch.empty(128, 128, device="meta", requires_grad=True)
    w = torch.empty(128, 128, device="meta")
    counter = OpCounter()
    with counter:
        c = x
        for _ in range(12):
            c = torch.tanh(c @ w)
        torch.autograd.grad(c.sum(), x)
    got = counter.report.flops
    assert abs(got - want) / want < 0.05, (got, want)
    # forward and the gradient of c: 24 products (w takes no gradient)
    assert counter.report.terms["products"] == 24 * 2 * 128 ** 3


def test_analyzer_counts_nested_products():
    """5 x 3 nested products: exactly 15 * 2 * 64^3 product FLOPs, and
    within 5% of ``analyze_hlo`` of the reference's nested scans."""
    import jax
    import jax.numpy as jnp
    from repro.perf import analyze_hlo

    def f(x, w):
        def outer(c, _):
            def inner(c2, _):
                return c2 @ w, None
            c2, _ = jax.lax.scan(inner, c, None, length=3)
            return c2, None
        y, _ = jax.lax.scan(outer, x, None, length=5)
        return y.sum()

    s = jax.ShapeDtypeStruct((64, 64), jnp.float32)
    ref = analyze_hlo(jax.jit(f).lower(s, s).compile().as_text()).flops
    x = torch.empty(64, 64, device="meta")
    w = torch.empty(64, 64, device="meta")
    counter = OpCounter()
    with counter:
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        x.sum()
    want = 15 * 2 * 64 ** 3
    assert counter.report.terms["products"] == want
    assert abs(counter.report.flops - ref) / ref < 0.05


def test_analyzer_counts_a_collective_per_layer():
    """An all-reduce in each of 6 layers over a fake 4-rank group: 6, with
    their operand and result bytes exactly."""
    import torch.distributed as dist
    with dr.fake_world(4):
        c = torch.empty(64, 64, device="meta")
        ws = torch.empty(6, 64, 64, device="meta")
        counter = OpCounter()
        with counter:
            for w in ws.unbind(0):
                c = c @ w
                dist.all_reduce(c)
    nbytes = 6 * 64 * 64 * 4
    assert counter.report.collectives == {"all-reduce": {
        "count": 6, "operand_bytes": nbytes, "result_bytes": nbytes}}
    assert counter.report.collective_bytes == nbytes
    assert not dist.is_initialized()


def test_bytes_and_memory_rules():
    """Views count nothing, an op reads its operands and writes its result,
    a write into a slice counts twice the slice; the memory reading holds
    the arguments, the results and the peak beyond the arguments."""
    x = torch.empty(1024, device="meta")
    counter = OpCounter()
    counter.arguments(x)
    with counter:
        v = x.view(32, 32).t()
        assert counter.report.bytes == 0
        y = x * 2
        z = y.exp()
        assert counter.report.bytes == 2 * 8192
        del y
        z[:16] = v[0, :16]
        assert counter.report.bytes == 2 * 8192 + 2 * 64
    counter.outputs(z)
    assert counter.report.memory == {"argument_bytes": 4096,
                                     "output_bytes": 4096,
                                     "temp_bytes": 8192}
    assert counter.report.terms == {"products": 0, "elementwise": 2048,
                                    "reductions": 0, "kernels": 0}
    del v


def test_extrapolate_is_exact_for_affine_costs():
    """Affine counts from two repeat counts; the peak above the arguments
    is the largest of the ops' extrapolated live bytes, which need not be
    the op that peaked in either trace."""
    base, step = OpCounter().report, OpCounter().report
    base.flops, base.bytes, step.flops, step.bytes = 10, 100, 13, 150
    base.live = {"a": [50, 30], "b": [40]}
    step.live = {"a": [51, 36], "b": [45], "middle": [99]}
    base.memory["argument_bytes"], step.memory["argument_bytes"] = 20, 22
    out = extrapolate(base, [(step, 6, 2)])
    assert (out.flops, out.bytes) == (22, 300)
    assert out.live == {"a": [54, 54], "b": [60]}
    assert out.memory["temp_bytes"] == 60 - 28


# -- meta equals real; scaled equals traced ------------------------------------

@pytest.mark.parametrize("kind", ["train", "decode"])
def test_meta_counts_equal_real(kind):
    """internlm2-1.8b at smoke widths on a fake 2x2 mesh: the step counted
    on meta tensors and run on real CPU tensors gives the same FLOPs,
    bytes, collectives, kernels and memory, exactly (no kernel on either
    route: training and decode run plain PyTorch).  A MoE config would
    not: ``F.one_hot`` checks its indices on the CPU with a host read and
    builds the one-hot another way on meta."""
    from repro_torch.launch.mesh import make_mesh
    cfg = _smoke("internlm2-1.8b", layers=2)
    shape = Shape(kind, kind, 32, 8)
    kw = (dict(rules=train_rules(), microbatches=2) if kind == "train"
          else dict(rules=serve_rules(kv_shard="seq")))
    with dr.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        meta = dr.trace_program(cfg, shape, mesh=mesh, scaled=False,
                                **kw).to_dict()
        real = dr.trace_program(cfg, shape, mesh=mesh, scaled=False,
                                device="cpu", **kw).to_dict()
    assert meta == real
    assert meta["terms"]["products"] > 0 and meta["bytes"] > 0
    if kind == "train":  # the loss's sums and the gradients' data mean
        assert set(meta["collectives"]) == {"all-reduce", "reduce-scatter",
                                            "all-gather"}


@pytest.mark.parametrize("arch,loops", [
    ("deepseek-v2-236b", dict(dense=3, moe=4)),
    ("recurrentgemma-2b", dict(layers=4)),
    ("whisper-base", dict(layers=4, encoder=3)),
    ("mamba2-2.7b", dict(layers=5)),
])
def test_scaled_trace_equals_full_trace(arch, loops):
    """Two and three repeats of every layer loop (each group, an encoder)
    and one and two microbatches, extrapolated, equal the whole program
    traced, exactly: FLOPs, bytes, collectives, kernel launches and memory,
    for a train step of 3 microbatches, a prefill (the kernels' meta
    routes) and a decode step.  recurrentgemma-2b keeps a tail group."""
    cfg = _smoke(arch, **loops)
    if cfg.pattern:
        cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
    img = cfg.img_tokens if cfg.frontend == "vlm_stub" else 0
    for shape, kw in [(Shape("t", "train", 64 + img, 6),
                       dict(microbatches=3)),
                      (Shape("p", "prefill", 48 + img, 2), {}),
                      (Shape("d", "decode", 64, 2), {})]:
        scaled = dr.trace_program(cfg, shape, **kw).to_dict()
        full = dr.trace_program(cfg, shape, scaled=False, **kw).to_dict()
        assert scaled == full, shape.kind
        if shape.kind == "prefill":
            assert full["kernels"], "no kernel counted in the prefill"


def test_memory_peak_that_moves_with_depth():
    """A head wide against its layers (vocab 4096 at d_model 64): the op at
    the peak of live bytes is another at 6 layers than at 1 or 2, so the
    peak is not affine from shallow traces; extrapolated op by op within
    segments it equals the whole program's at 6 layers, exactly."""
    cfg = dataclasses.replace(_smoke("internlm2-1.8b"), vocab=4096)
    shape = Shape("t", "train", 16, 2)
    full = {n: dr.trace_program(dataclasses.replace(cfg, n_layers=n), shape,
                                scaled=False).memory["temp_bytes"]
            for n in (1, 2, 6)}
    assert full[1] + 5 * (full[2] - full[1]) != full[6]
    got = dr.trace_program(dataclasses.replace(cfg, n_layers=6), shape)
    assert got.memory["temp_bytes"] == full[6]


def test_prefill_kernel_launches_follow_the_card():
    """On meta tensors each prefill kernel is counted once a layer of its
    kind, under the CUDA kernel of the dtype (bf16: ``*_tc``; float32:
    ``*_tc32``), and the module counters of real launches stay at 0."""
    from repro_torch.kernels import (flash_attention_tc, rg_lru_pipe,
                                     ssd_scan_tc32)
    mods = (flash_attention_tc, rg_lru_pipe, ssd_scan_tc32)
    before = [m.launches for m in mods]
    shape = Shape("p", "prefill", 40, 2)
    rg = dr.trace_program(_smoke("recurrentgemma-2b", layers=2), shape)
    assert rg.kernels["rg_lru_pipe"]["launches"] == 4
    assert rg.kernels["flash_attention_tc"]["launches"] == 2
    cfg = dataclasses.replace(_smoke("mamba2-2.7b", layers=3),
                              dtype="float32")
    ssm = dr.trace_program(cfg, shape)
    assert set(ssm.kernels) == {"ssd_scan_tc32"}
    assert ssm.kernels["ssd_scan_tc32"]["launches"] == 3
    assert [m.launches for m in mods] == before


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b",
                                  "recurrentgemma-2b"])
def test_prefill_arguments_equal_what_the_engine_holds(arch):
    """Phase 11's byte check at smoke widths on the CPU: the prefill traced
    on a 1x1 mesh over a one-rank fake group holds, as arguments, exactly
    the bytes an ``Engine`` holds for the same model, cache and prompt (the
    cast parameters, the cache, the token ids: ``run_serving``'s
    ``held_bytes``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params, param_specs
    from repro_torch.perf import storage_bytes
    from repro_torch.serve import Engine
    cfg = get_config(arch, smoke=True)
    eng = Engine(cfg, init_params(param_specs(cfg), 0, device="cpu"),
                 batch=2, max_len=64, device="cpu")
    held = (storage_bytes(eng.params.values())
            + storage_bytes(eng.cache.values())
            + storage_bytes([eng._tokens(np.zeros((2, 40), np.int64))]))
    with dr.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        rep = dr.trace_program(cfg, Shape("p", "prefill", 40, 2), mesh=mesh,
                               rules=serve_rules(kv_shard=dr.KV_SHARD[arch]),
                               cache_len=64, enc_len=0)
    assert rep.memory["argument_bytes"] == held
    assert rep.kernels


# -- the work functions: chip_smoke.py's bounds ----------------------------------

# PERF §6's shapes: B3 (B, H, K, S, T, d, dv, causal, window)
ATTN_SHAPES = [(4, 16, 8, 2000, 2000, 128, 128, True, None),
               (4, 10, 1, 2000, 2000, 256, 256, True, 2048),
               (4, 16, 16, 2000, 2000, 256, 256, True, None),
               (4, 64, 8, 2000, 2000, 128, 128, True, None),
               (4, 40, 8, 2000, 2000, 128, 128, True, None),
               (4, 128, 128, 2000, 2000, 192, 128, True, None),
               (4, 32, 8, 2576, 2576, 128, 128, True, None),
               (4, 8, 8, 1500, 1500, 64, 64, False, None),
               (4, 8, 8, 8, 8, 64, 64, True, None),
               (4, 8, 8, 8, 1500, 64, 64, False, None)]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_attention_work_equals_chip_smoke_bound(shape, itemsize):
    """B3's ``work`` gives the FLOP and bytes ``chip_smoke.py`` counted for
    its bounds before it read ``work`` (causal S(S+1)/2 pairs or S·T,
    2·B·H·(d + dv) a pair; q, k, v and the output once)."""
    from repro_torch.kernels.flash_attention_tc import work
    B, H, K, S, T, d, dv, causal, window = shape
    pairs = S * (S + 1) // 2 if causal else S * T
    want = (2 * B * H * (d + dv) * pairs,
            itemsize * (B * H * S * d + B * K * T * d + B * K * T * dv
                        + B * H * S * dv))
    assert work(B, H, K, S, T, d, dv, causal=causal, window=window,
                t_actual=T, itemsize=itemsize) == want


def test_attention_work_counts_the_window():
    """The attended pairs are those the attention mask keeps (the model's
    ``_mask_bias``: keys below t_actual, causal, within the window); where
    the window binds (32k positions, window 2048) they are
    sum min(i + 1, window)."""
    from repro_torch.kernels.flash_attention_tc import attended_pairs
    from repro_torch.models.attention import _mask_bias
    for S, T, causal, window, t_actual in [
            (10, 10, True, None, 4), (6, 8, False, 3, 8), (40, 40, True, 7, 40),
            (9, 30, False, None, 21), (33, 33, True, 5, 20)]:
        keep = _mask_bias(torch.arange(S), torch.arange(T), causal=causal,
                          window=window, t_actual=t_actual).expand(S, T) == 0
        assert attended_pairs(S, T, causal=causal, window=window,
                              t_actual=t_actual) == int(keep.sum())
    S, w = 32768, 2048
    assert attended_pairs(S, S, causal=True, window=w, t_actual=S) == sum(
        min(i + 1, w) for i in range(S))


@pytest.mark.parametrize("itemsize", [2, 4])
def test_ssd_and_rg_lru_work_equal_chip_smoke_bounds(itemsize):
    """B4's and B5's ``work`` at PERF §6's shapes, against the formulas
    ``chip_smoke.py`` kept for their bounds, and the bounds PERF §6
    records (bf16 B4 0.0785 ms by bytes, float32 0.175 by operations; B5
    0.0734 by bytes)."""
    import chip_smoke as cs
    from repro_torch.kernels import rg_lru_pipe, ssd_scan_tc
    B, H, S, P, N = 4, 80, 2000, 64, 128
    chunk = ssd_scan_tc.CHUNK
    pairs = sum(min(chunk, S - s0) * (min(chunk, S - s0) + 1) // 2
                for s0 in range(0, S, chunk))
    want = (2 * B * H * (pairs * (N + P) + 2 * S * N * P),
            itemsize * (B * S * H * P + 2 * B * S * N)
            + 4 * (B * H * S + H) + 4 * (B * H * S * P + B * H * N * P))
    got = ssd_scan_tc.work(B, H, S, P, N, itemsize=itemsize)
    assert got == want
    rate = cs.BF16_FLOPS if itemsize == 2 else cs.F32_MMA_FLOPS
    bound = max(got[0] / rate, got[1] / cs.HBM_BYTES_PER_S) * 1e3
    assert round(bound, 4 if itemsize == 2 else 3) == (
        0.0785 if itemsize == 2 else 0.175)
    flops, nbytes = rg_lru_pipe.work(4, 2000, 2560, itemsize=4)
    assert (flops, nbytes) == (2 * 4 * 2000 * 2560, 12 * 4 * 2000 * 2560)
    assert round(nbytes / cs.HBM_BYTES_PER_S * 1e3, 4) == 0.0734


def test_attention_bounds_equal_perf_table():
    """The bf16 and float32 bounds of PERF §6's B3 rows at d 128 and 256,
    from ``work`` at the card's rates."""
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention_tc import work
    want = {(2, 128): 0.0663, (2, 256): 0.0829, (4, 128): 0.397,
            (4, 256): 0.497}
    for (itemsize, d), ms in want.items():
        shape = (4, 16, 8, 2000) if d == 128 else (4, 10, 1, 2000)
        B, H, K, S = shape
        flops, nbytes = work(B, H, K, S, S, d, d, causal=True, window=None,
                             t_actual=S, itemsize=itemsize)
        rate = cs.BF16_FLOPS if itemsize == 2 else cs.F32_MMA_FLOPS
        bound = max(flops / rate, nbytes / cs.HBM_BYTES_PER_S) * 1e3
        assert float(f"{bound:.3g}") == ms, (itemsize, d, bound)


# -- every cell against the reference -----------------------------------------------

@pytest.mark.parametrize("pair", PAIRS, ids=["production", "override"])
def test_state_bytes_equal_reference_on_every_cell(pair, background,
                                                   override):
    """All 80 (arch x shape x mesh) cells on both meshes of the pair: the
    status or skip reason, the meta fields and ``state_bytes_per_device``
    equal the reference's ``build_cell`` and ``_analytic_state_bytes``,
    exactly.  No cell is refused: the ``TRAIN_NO_TP`` cells train under
    ``tp=False``."""
    got = {}
    for mp, shape in zip((False, True), pair):
        override(shape)
        with dr.fake_world(math.prod(shape)):
            for a in sorted(ARCHS):
                for s in sorted(SHAPES):
                    key = "x".join(map(str, shape)) + f"/{a}/{s}"
                    try:
                        cell = dr.build_cell(a, s, multi_pod=mp)
                    except dr.SkipCell as e:
                        got[key] = {"status": "skip", "reason": str(e)}
                        continue
                    got[key] = {"status": "ok", **cell.meta,
                                "n_devices": math.prod(shape),
                                "state_bytes_per_device": cell.state_bytes}
    ref = background.reference()["state"]
    assert len(got) == 80
    assert got == {k: ref[k] for k in got}
    assert sum(v["status"] == "skip" for v in got.values()) == 16
    assert not hasattr(dr.Cell, "refused")


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16), (2, 4), (2, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_held_bytes_equal_state_bytes_on_every_train_cell(shape, override):
    """On every train cell of the production and override meshes the
    bytes the port's program holds on a device (its parameters', moments'
    and batch's blocks: ``explicit_state_bytes_per_device``) equal the
    reference's analytic ``state_bytes_per_device``, exactly: the trainer
    holds the reference's block of every tensor.  Until the trainer's
    tensor parallelism and FSDP they were 24-496x larger."""
    override(shape)
    mp = len(shape) == 3
    cells = 0
    with dr.fake_world(math.prod(shape)):
        for a in sorted(ARCHS):
            cell = dr.build_cell(a, "train_4k", multi_pod=mp)
            assert cell.held_bytes() == cell.state_bytes, (a, shape)
            cells += 1
    assert cells == len(ARCHS)


SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16), (2, 4), (2, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_held_bytes_equal_state_bytes_on_every_serve_cell(shape, override):
    """On every prefill and decode cell of the production and override
    meshes the bytes the port's program holds on a device (its cast
    weights', cache's and token ids' blocks, and decode's position:
    ``explicit_state_bytes_per_device``) equal the reference's analytic
    ``state_bytes_per_device``, exactly: prefill and decode hold the
    reference's block of every tensor under ``serving_rules``.  Until
    serving's tensor parallelism they were 3.7-27x larger."""
    override(shape)
    mp = len(shape) == 3
    cells = 0
    with dr.fake_world(math.prod(shape)):
        for a in sorted(ARCHS):
            for s in SERVE_SHAPES:
                try:
                    cell = dr.build_cell(a, s, multi_pod=mp)
                except dr.SkipCell:
                    continue
                assert cell.held_bytes() == cell.state_bytes, (a, s, shape)
                cells += 1
    assert cells == 2 * len(ARCHS) + 2


def _attention_flops(cfg, shape, rows) -> int:
    """Every (q block, kv block) tile of the reference's scan over S
    positions: 2·(d + dv) FLOP a head and pair of positions."""
    S = shape.seq
    return (2 * (cfg.hd + cfg.hd) * cfg.n_heads * rows * S * S
            * cfg.n_layers)


@pytest.mark.parametrize("cell", list(FLOP_CELLS), ids="/".join)
def test_product_flops_match_reference_on_8x1(cell, background, override):
    """On the 8x1 override mesh the model axis has size 1, and the
    reference's partitioned program does the port's per-device work.  The
    port's product FLOPs within 1% of the reference's (2% for
    prefill_32k, attention taken out of both sides)."""
    arch, shape_name = cell
    override((8, 1))
    with dr.fake_world(8):
        rep = dr.build_cell(arch, shape_name, multi_pod=False).trace()
    port = rep.terms["products"]
    ref = background.reference()["flops"]["/".join(cell)]
    if shape_name == "prefill_32k":
        cfg, shape = get_config(arch), SHAPES[shape_name]
        ref -= _attention_flops(cfg, shape, shape.batch // 8)
        assert rep.kernels["flash_attention_tc"]["launches"] == cfg.n_layers
    assert abs(port / ref - 1) < FLOP_CELLS[cell], (port, ref, port / ref)


def test_train_step_with_attention_skips_the_masked_tiles(background,
                                                          override):
    """internlm2-1.8b train_4k on the 8x1 mesh: the reference's scan
    differentiates every (q block, kv block) tile, masked or not, and the
    port's ``blockwise_attention`` stops at the causal edge, so the port's
    product FLOPs per device fall short of the reference's.  The port's
    side is the cell itself (``tp=False``: 32 rows a device, FSDP over the
    mesh).  When this file was written: 1.89068e15 against 2.05041e15,
    0.9221."""
    override((8, 1))
    with dr.fake_world(8):
        port = dr.build_cell(*ATTENTION_CELL,
                             multi_pod=False).trace().terms["products"]
    ref = background.reference()["flops"]["/".join(ATTENTION_CELL)]
    assert 0.85 < port / ref < 0.97, (port, ref, port / ref)


TP_FLOP_CELLS = [("mamba2-2.7b", "train_4k"), ("qwen2-72b", "train_4k"),
                 ("mamba2-2.7b", "prefill_32k"), ("qwen2-72b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape_name", TP_FLOP_CELLS, ids=[
    a if s == "train_4k" else f"{a}-{s}" for a, s in TP_FLOP_CELLS])
def test_tensor_parallel_flops_fall_by_the_model_axis(arch, shape_name,
                                                      override):
    """A cell on the 2x4 override mesh against 8x1: a quarter of the
    rows a device on 8x1 is the whole of a model group's rows on 2x4, and
    tensor parallelism splits every product of the step (the prefill's
    attention kernel too, on each rank's heads) over the four model
    ranks, so the port's product FLOPs a device are within 5% of its own
    on 8x1.  When this file was written: train_4k mamba2-2.7b 2.92972e15
    against 2.92972e15 (the reference's on 2x4: 2.93127e15); qwen2-72b
    7.30417e16 against 7.30417e16 (the reference's: 7.51732e16; its
    attention differentiates every tile); prefill_32k mamba2-2.7b
    6.74139e14 and qwen2-72b 1.84058e16, equal on both meshes.
    ``scripts/dryrun_tp_flops.py`` prints the reference's train_4k
    FLOPs."""
    flops = {}
    for shape in ((8, 1), (2, 4)):
        override(shape)
        with dr.fake_world(8):
            flops[shape] = dr.build_cell(arch, shape_name, multi_pod=False
                                         ).trace().terms["products"]
    ratio = flops[2, 4] / flops[8, 1]
    assert abs(ratio - 1) < 0.05, (arch, flops, ratio)


@pytest.mark.parametrize("arch,shape,mp", MINI_CELLS,
                         ids=lambda v: str(v))
def test_reference_mini_cells_through_port_cli(arch, shape, mp, background):
    """The reference's ``test_mini_dryrun_cell`` cells and its skip rule
    through the port's CLI on 8 fake ranks: status ``ok`` (``skip`` for
    qwen2-72b long_500k), FLOPs > 0 and state bytes equal to the
    reference's; the bytes the program holds equal them too, and no
    mapping is left unapplied."""
    rec = background.record(arch, shape, mp)
    mesh = "2x2x2" if mp else "2x4"
    ref = background.reference()["state"][f"{mesh}/{arch}/{shape}"]
    if ref["status"] == "skip":
        assert rec["status"] == "skip" and rec["reason"] == ref["reason"]
        return
    assert rec["state_bytes_per_device"] == ref["state_bytes_per_device"]
    assert rec["status"] == "ok"
    assert rec["explicit_state_bytes_per_device"] \
        == rec["state_bytes_per_device"]
    assert "not applied" not in json.dumps(
        {k: v for k, v in rec["sharding_report"].items()
         if k != "activations"})
    assert rec["flops_per_device"] > 0
    assert rec["explicit_state_bytes_per_device"] > 0
    if mp and shape == "train_4k":
        assert rec["collectives"]["all-reduce"]["count"] > 0
    assert np.isfinite(rec["traffic_bytes_per_device"])


@pytest.mark.parametrize("arch", NO_TP_CELLS)
def test_token_parallel_cells_within_the_reference(arch, background):
    """The ``TRAIN_NO_TP`` archs' train_4k on the 2x2x2 override through
    the port's CLI (multi-pod ``tp=False``: the batch over "pod" and
    "data", each rank's positions over "model"; the traced rank the last
    block of "model", whose queries attend every key) against the
    reference's compiled cell: the port's products and reductions a
    device at most the reference's, its peak temporary bytes at most 1.25
    times the reference's.  When this file was written: internlm2-1.8b
    1.997e15 against 2.474e15 and 235.6 against 292.2 GB (3.783e15 and
    469.5 GB while the port held the whole sequence on each model rank);
    whisper-base 1.401e14 against 2.231e14 and 125.4 against 240.2 GB
    (2.669e14)."""
    rec = background.record(arch, "train_4k", True)
    ref = background.reference()["no_tp"][arch]
    terms = rec["flop_terms"]
    assert rec["traced_coords"] == {"pod": 0, "data": 0, "model": 1}
    assert terms["products"] + terms["reductions"] <= ref["flops"], \
        (terms, ref)
    assert rec["memory_analysis"]["temp_bytes"] <= 1.25 * ref["temp"], \
        (rec["memory_analysis"], ref)
    assert "activations" not in rec["sharding_report"]


def test_sequence_parallel_cell_lowers_the_peak(background, override):
    """internlm2-20b train_4k on the 2x4 override under
    ``train_rules(seq_shard=True)`` (its CLI's ``--seq-shard``) against
    the same cell without: the residual stream is split over "model"
    between the tensor-parallel regions (Megatron's sequence
    parallelism), so the peak temporary bytes a device fall and the
    products stay within 1%.  When this file was written: 213.6 against
    347.6 GB, products 2.03967e16 on both."""
    sp = background.record("internlm2-20b", "train_4k", False, "sp")
    override((2, 4))
    with dr.fake_world(8, dr.traced_rank("train_4k", False)):
        plain = dr.build_cell("internlm2-20b", "train_4k",
                              multi_pod=False).trace()
    assert sp["memory_analysis"]["temp_bytes"] \
        < 0.75 * plain.memory["temp_bytes"]
    assert abs(sp["flop_terms"]["products"] / plain.terms["products"]
               - 1) < 0.01
