"""The port's serving engine and session store against the JAX package's.

Same numpy parameters in both packages (made by the reference's
``init_params``), a ``dtype="float32"`` smoke config where tokens are
compared, and prompt lengths that are not multiples of ``decode_tail``
(see tests/test_torch_models.py for that case).  What must match: greedy
tokens exactly, session window files byte for byte, flushed byte counts.
"""

import dataclasses
import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as j_get_config
from repro.models import init_cache_specs as j_cache_specs
from repro.models import init_params as j_init_params
from repro.models import param_specs as j_param_specs
from repro.serve import Engine as JEngine
from repro.serve import SessionStore as JSessionStore
import repro_torch.core as tcore
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tree_from_numpy
from repro_torch.models import init_cache_specs, init_params, param_specs
from repro_torch.models.lm import TAIL_TO_MAIN
from repro_torch.serve import Engine, SessionStore

ARCH = "internlm2-1.8b"
ROOT = Path(__file__).resolve().parents[1]
B, PROMPT, MAX_LEN = 2, 6, 32


@functools.cache
def _chip_smoke():
    """``chip_smoke.py`` (the repo root's script) as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def configs(dtype="float32"):
    return (dataclasses.replace(j_get_config(ARCH, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype))


def numpy_params(jcfg, seed=0):
    return {k: np.asarray(v) for k, v in
            j_init_params(j_param_specs(jcfg), jax.random.PRNGKey(seed)).items()}


def prompt(vocab, n=PROMPT, seed=5):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, n)).astype(np.int32)


def test_generate_tokens_match_reference():
    """14 greedy tokens from a 6-token prompt: the tail merges at
    positions 8 and 16 on the way."""
    jcfg, cfg = configs()
    params = numpy_params(jcfg)
    toks = prompt(cfg.vocab)
    want = JEngine(jcfg, params, batch=B, max_len=MAX_LEN).generate(
        {"inputs": jnp.asarray(toks)}, 14)
    eng = Engine(cfg, params_from_numpy(cfg, params, device="cpu"), batch=B,
                 max_len=MAX_LEN, device="cpu")
    got = eng.generate({"inputs": toks}, 14)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_engine_kill_and_resume_is_exact(tmp_path):
    """tests/test_train_serve.py::test_engine_greedy_generation_and_session
    on the port: run 2 steps, persist, drop the engine, reopen, continue."""
    cfg = get_config(ARCH, smoke=True)
    params = init_params(param_specs(cfg), 0, device="cpu")
    steps = 5
    toks = prompt(cfg.vocab)
    store = SessionStore(tcore.Communicator(1), str(tmp_path / "sess.bin"),
                         init_cache_specs(cfg, B, MAX_LEN), factor="0.5")
    eng = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                 device="cpu")
    out_full = eng.generate({"inputs": toks}, steps)
    assert out_full.shape == (B, steps)

    eng2 = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                  device="cpu")
    seq = [eng2.prefill({"inputs": toks})]
    seq.append(eng2.step(seq[0]))
    eng2.generated = list(seq)
    assert eng2.save_session() > 0
    del eng2
    eng3 = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                  device="cpu")
    eng3.load_session()
    assert eng3.pos == PROMPT + 1
    assert all(t.dtype == torch.bfloat16 for t in eng3.cache.values())
    cont = seq[1]
    for _ in range(steps - 2):
        cont = eng3.step(cont)
        seq.append(cont)
    np.testing.assert_array_equal(np.stack(seq, axis=1), out_full)
    _, _, ring = store.load(eng3.cache_specs, "cpu")
    np.testing.assert_array_equal(ring[:2 * B],
                                  np.stack(seq[:2], axis=1).reshape(-1))
    store.free()


@pytest.mark.parametrize("factor", [None, "0.5"])
def test_session_files_byte_identical(tmp_path, factor):
    """The same cache (bf16 bits), pos and tokens saved by both packages:
    the same flushed byte count and the same window file."""
    jcfg, cfg = configs("bfloat16")
    rng = np.random.default_rng(9)
    jspecs, specs = j_cache_specs(jcfg, B, MAX_LEN), init_cache_specs(cfg, B, MAX_LEN)
    bits = {k: rng.integers(0, 1 << 15, size=s.shape, dtype=np.uint16)
            for k, s in specs.items()}
    toks = rng.integers(0, cfg.vocab, size=B * 7).astype(np.int32)
    out = []
    for name, store_cls, comm, spec, cache in (
            ("ref.bin", JSessionStore, jcore.Communicator(1), jspecs,
             {k: jnp.asarray(b.view(ml_dtypes.bfloat16)) for k, b in bits.items()}),
            ("port.bin", SessionStore, tcore.Communicator(1), specs,
             tree_from_numpy({k: b.view(ml_dtypes.bfloat16)
                              for k, b in bits.items()}, device="cpu"))):
        store = store_cls(comm, str(tmp_path / name), spec, factor=factor)
        flushed = store.save(cache, PROMPT + 7, toks)
        store.free()
        out.append((flushed, (tmp_path / name).read_bytes()))
    assert out[0][0] > 0
    assert out[0] == out[1]


def test_reference_session_continues_in_port(tmp_path):
    """A decode state saved by the JAX engine, opened by the port's
    SessionStore on the same file, continues with the JAX engine's
    tokens."""
    jcfg, cfg = configs()
    params = numpy_params(jcfg, seed=3)
    toks = prompt(cfg.vocab, seed=6)
    path = str(tmp_path / "sess.bin")
    jstore = JSessionStore(jcore.Communicator(1), path,
                           j_cache_specs(jcfg, B, MAX_LEN))
    jeng = JEngine(jcfg, params, batch=B, max_len=MAX_LEN, session=jstore)
    seq = [jeng.prefill({"inputs": jnp.asarray(toks)})]
    for _ in range(3):
        seq.append(jeng.step(seq[-1]))
    jeng.generated = list(seq)
    jeng.save_session()
    jstore.free()
    want = [seq[-1]]
    for _ in range(6):  # crosses the merge at position 16
        want.append(jeng.step(want[-1]))

    store = SessionStore(tcore.Communicator(1), path,
                         init_cache_specs(cfg, B, MAX_LEN))
    eng = Engine(cfg, params_from_numpy(cfg, params, device="cpu"), batch=B,
                 max_len=MAX_LEN, session=store, device="cpu")
    eng.load_session()
    assert eng.pos == jeng.pos - 6
    got = [seq[-1]]
    for _ in range(6):
        got.append(eng.step(got[-1]))
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    store.free()


def test_params_from_numpy_checks_names_shapes_dtypes():
    jcfg, cfg = configs()
    params = numpy_params(jcfg)
    tp = params_from_numpy(cfg, params, device="cpu")
    assert all(torch.equal(tp[k], torch.from_numpy(v.copy())) for k, v in params.items())
    wrong_name = dict(params)
    wrong_name["g0/p0/wq_x"] = wrong_name.pop("g0/p0/wq")
    wrong_shape = dict(params, **{"final_norm": np.zeros(3, np.float32)})
    wrong_dtype = dict(params, **{"final_norm":
                                  params["final_norm"].astype(np.float16)})
    for bad, match in ((wrong_name, "names"), (wrong_shape, "final_norm"),
                       (wrong_dtype, "final_norm")):
        with pytest.raises(ValueError, match=match):
            params_from_numpy(cfg, bad, device="cpu")


def test_engine_rejects_bad_tokens_and_full_cache():
    cfg = get_config(ARCH, smoke=True)
    eng = Engine(cfg, init_params(param_specs(cfg), 0, device="cpu"), batch=B,
                 max_len=8, device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        eng.prefill({"inputs": np.full((B, 3), cfg.vocab)})
    with pytest.raises(ValueError, match="prompt length"):
        eng.prefill({"inputs": np.zeros((B, 9), np.int32)})
    nxt = eng.prefill({"inputs": np.zeros((B, 8), np.int32)})
    with pytest.raises(ValueError, match="8 positions"):
        eng.step(nxt)


def test_serve_launcher_runs_on_the_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "4", "--session",
         str(tmp_path / "s.bin")],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "generated token ids" in r.stdout and "session flushed" in r.stdout


def test_serving_slice_matches_reference(tmp_path):
    """The slice as a whole: ``chip_smoke.run_serving`` (phase 3's routine:
    generate; then prefill, steps, save, a fresh engine, load, steps; then
    the consistency check) on the CPU at the smoke config, against the JAX
    engine's greedy tokens for the same parameters and prompt.  The prompt
    (13) is not a multiple of decode_tail (8); 12 steps cross merges at 16
    and 24, and the session is saved at token 5."""
    chip_smoke = _chip_smoke()
    jcfg, cfg = configs()
    params = numpy_params(jcfg, seed=4)
    tokens = prompt(cfg.vocab, n=14, seed=8)
    want = JEngine(jcfg, params, batch=B, max_len=MAX_LEN).generate(
        {"inputs": jnp.asarray(tokens[:, :13])}, 12)
    out = chip_smoke.run_serving(
        cfg, params_from_numpy(cfg, params, device="cpu"), tokens,
        device="cpu", directory=tmp_path, max_len=MAX_LEN, steps=12,
        save_at=5, factor="0.5")
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))
    assert out["session_flushed_bytes"] > 0
    # the cache is bf16 even in a float32 config: decode reads rounded k/v
    assert out["consistency_rel_err"] < 0.02
    assert len(out["step_ms"]) == 11


def test_serving_entry_points_default_to_cuda():
    """Engine, init_params and params_from_numpy allocate on the card unless
    asked for the CPU, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jcfg, cfg = configs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(param_specs(cfg), 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(cfg, numpy_params(jcfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, init_params(param_specs(cfg), 0, device="cpu"), batch=B,
               max_len=8)


# -- Mamba-2 (ssm blocks: float32 state, bf16 conv carry, no two-tier tail) ---

SSM_ARCH = "mamba2-2.7b"


def ssm_configs(dtype="float32"):
    return (dataclasses.replace(j_get_config(SSM_ARCH, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(SSM_ARCH, smoke=True), dtype=dtype))


def ssm_numpy_params(chip_smoke, jcfg, seed=0):
    """The reference's init with ``A_log`` and ``dt_bias`` in Mamba-2's
    published ranges, so the state carries across the session."""
    out = numpy_params(jcfg, seed)
    out.update(chip_smoke.ssm_dynamics(get_config(SSM_ARCH, smoke=True), seed))
    return out


def test_mamba2_engine_kill_and_resume_is_exact(tmp_path):
    """tests/test_train_serve.py::test_engine_greedy_generation_and_session
    on the port's Mamba-2: generate; then prefill, steps, save at a mid
    step, drop the engine, load into a fresh one, continue."""
    cs = _chip_smoke()
    cfg = get_config(SSM_ARCH, smoke=True)
    params = cs.model_params(cfg, 0, "cpu")
    steps, save_at = 9, 4
    toks = prompt(cfg.vocab, n=19)
    specs = init_cache_specs(cfg, B, MAX_LEN)
    store = SessionStore(tcore.Communicator(1), str(tmp_path / "sess.bin"),
                         specs, factor="0.5")
    eng = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                 device="cpu")
    assert not any(k.split("/")[-1] in TAIL_TO_MAIN for k in eng.cache_specs)
    out_full = eng.generate({"inputs": toks}, steps)

    eng2 = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                  device="cpu")
    seq = [eng2.prefill({"inputs": toks})]
    for _ in range(save_at - 1):
        seq.append(eng2.step(seq[-1]))
    eng2.generated = list(seq)
    h_saved = eng2.cache["g0/p0/h"].clone()
    assert eng2.save_session() > 0
    del eng2
    eng3 = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                  device="cpu")
    eng3.load_session()
    assert eng3.pos == toks.shape[1] + save_at - 1
    assert eng3.cache["g0/p0/h"].dtype == torch.float32
    assert eng3.cache["g0/p0/conv"].dtype == torch.bfloat16
    assert torch.equal(eng3.cache["g0/p0/h"], h_saved)
    for _ in range(steps - save_at):
        seq.append(eng3.step(seq[-1]))
    np.testing.assert_array_equal(np.stack(seq, axis=1), out_full)
    store.free()


@pytest.mark.parametrize("factor", [None, "0.5"])
def test_mamba2_session_files_byte_identical(tmp_path, factor):
    """The same Mamba-2 cache (float32 ``h``, bf16 ``conv`` bits), pos and
    tokens saved by both packages' stores: the same flushed byte count and
    the same window file."""
    jcfg, cfg = ssm_configs("bfloat16")
    rng = np.random.default_rng(11)
    jspecs = j_cache_specs(jcfg, B, MAX_LEN)
    specs = init_cache_specs(cfg, B, MAX_LEN)
    cache = {}
    for k, s in specs.items():
        if s.dtype == "bfloat16":
            cache[k] = rng.integers(0, 1 << 15, size=s.shape,
                                    dtype=np.uint16).view(ml_dtypes.bfloat16)
        else:
            cache[k] = rng.standard_normal(s.shape).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=B * 5).astype(np.int32)
    out = []
    for name, store_cls, comm, spec, tree in (
            ("ref.bin", JSessionStore, jcore.Communicator(1), jspecs,
             {k: jnp.asarray(v) for k, v in cache.items()}),
            ("port.bin", SessionStore, tcore.Communicator(1), specs,
             tree_from_numpy(cache, device="cpu"))):
        store = store_cls(comm, str(tmp_path / name), spec, factor=factor)
        flushed = store.save(tree, PROMPT + 5, toks)
        store.free()
        out.append((flushed, (tmp_path / name).read_bytes()))
    assert out[0][0] > 0
    assert out[0] == out[1]


def test_mamba2_serving_slice_matches_reference(tmp_path):
    """The Mamba-2 slice as a whole: ``chip_smoke.run_serving`` (phase 4's
    routine) on the CPU at the float32 smoke config, against the JAX
    engine's greedy tokens for the same parameters and prompt.  The
    prompt (37) spans three of the smoke config's 16-position chunks."""
    cs = _chip_smoke()
    jcfg, cfg = ssm_configs()
    params = ssm_numpy_params(cs, jcfg, seed=4)
    tokens = prompt(cfg.vocab, n=38, seed=8)
    want = JEngine(jcfg, params, batch=B, max_len=64).generate(
        {"inputs": jnp.asarray(tokens[:, :37])}, 10)
    out = cs.run_serving(
        cfg, params_from_numpy(cfg, params, device="cpu"), tokens,
        device="cpu", directory=tmp_path, max_len=64, steps=10, save_at=4,
        factor="0.5")
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))
    assert out["session_flushed_bytes"] > 0
    assert out["consistency_rel_err"] < 0.02
    assert len(out["step_ms"]) == 9


def test_serve_launcher_runs_mamba2_on_the_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", SSM_ARCH,
         "--smoke", "--device", "cpu", "--steps", "4", "--session",
         str(tmp_path / "s.bin")],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "generated token ids" in r.stdout and "session flushed" in r.stdout


# -- RecurrentGemma (rglru and local_attn blocks: a float32 state, a bf16
# conv carry and a ring of min(max_len, window) slots, no two-tier tail) ---

RG_ARCH = "recurrentgemma-2b"


def rg_configs(dtype="float32"):
    return (dataclasses.replace(j_get_config(RG_ARCH, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(RG_ARCH, smoke=True), dtype=dtype))


def rg_numpy_params(chip_smoke, jcfg, seed=0):
    """The reference's init with ``lam`` in Griffin's published range, so
    the RG-LRU state carries across the session."""
    out = numpy_params(jcfg, seed)
    out.update(chip_smoke.rglru_dynamics(get_config(RG_ARCH, smoke=True),
                                         seed))
    return out


def test_recurrentgemma_engine_kill_and_resume_is_exact(tmp_path):
    """Generate; then prefill, steps past the ring's wrap (window 32: a
    prompt of 29, saved at position 35), save, drop the engine, load into a
    fresh one, continue: the same tokens and the same final state."""
    cs = _chip_smoke()
    cfg = get_config(RG_ARCH, smoke=True)
    params = cs.model_params(cfg, 0, "cpu")
    steps, save_at = 12, 7
    toks = prompt(cfg.vocab, n=29)
    specs = init_cache_specs(cfg, B, MAX_LEN * 2)
    store = SessionStore(tcore.Communicator(1), str(tmp_path / "sess.bin"),
                         specs, factor="0.5")
    eng = Engine(cfg, params, batch=B, max_len=MAX_LEN * 2, session=store,
                 device="cpu")
    assert not any(k.split("/")[-1] in TAIL_TO_MAIN for k in eng.cache_specs)
    assert eng.cache["g0/p2/k"].shape[2] == cfg.window == 32
    out_full = eng.generate({"inputs": toks}, steps)
    final = {k: v.clone() for k, v in eng.cache.items()}

    eng2 = Engine(cfg, params, batch=B, max_len=MAX_LEN * 2, session=store,
                  device="cpu")
    seq = [eng2.prefill({"inputs": toks})]
    for _ in range(save_at - 1):
        seq.append(eng2.step(seq[-1]))
    eng2.generated = list(seq)
    assert eng2.pos == 35 > cfg.window
    ring = eng2.cache["g0/p2/k"].clone()
    assert eng2.save_session() > 0
    del eng2
    eng3 = Engine(cfg, params, batch=B, max_len=MAX_LEN * 2, session=store,
                  device="cpu")
    eng3.load_session()
    assert eng3.pos == 35
    assert eng3.cache["g0/p0/h"].dtype == torch.float32
    assert eng3.cache["g0/p2/k"].dtype == torch.bfloat16
    assert torch.equal(eng3.cache["g0/p2/k"], ring)
    for _ in range(steps - save_at):
        seq.append(eng3.step(seq[-1]))
    np.testing.assert_array_equal(np.stack(seq, axis=1), out_full)
    assert all(torch.equal(v, eng3.cache[k]) for k, v in final.items())
    store.free()


@pytest.mark.parametrize("factor", [None, "0.5"])
def test_recurrentgemma_session_files_byte_identical(tmp_path, factor):
    """The same RecurrentGemma cache (float32 ``h``, bf16 ``conv`` and ring
    bits), pos and tokens saved by both packages' stores: the same flushed
    byte count and the same window file."""
    jcfg, cfg = rg_configs("bfloat16")
    rng = np.random.default_rng(12)
    jspecs = j_cache_specs(jcfg, B, MAX_LEN * 2)
    specs = init_cache_specs(cfg, B, MAX_LEN * 2)
    assert sorted(jspecs) == sorted(specs)
    cache = {}
    for k, s in specs.items():
        if s.dtype == "bfloat16":
            cache[k] = rng.integers(0, 1 << 15, size=s.shape,
                                    dtype=np.uint16).view(ml_dtypes.bfloat16)
        else:
            cache[k] = rng.standard_normal(s.shape).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, size=B * 9).astype(np.int32)
    out = []
    for name, store_cls, comm, spec, tree in (
            ("ref.bin", JSessionStore, jcore.Communicator(1), jspecs,
             {k: jnp.asarray(v) for k, v in cache.items()}),
            ("port.bin", SessionStore, tcore.Communicator(1), specs,
             tree_from_numpy(cache, device="cpu"))):
        store = store_cls(comm, str(tmp_path / name), spec, factor=factor)
        flushed = store.save(tree, 40, toks)
        store.free()
        out.append((flushed, (tmp_path / name).read_bytes()))
    assert out[0][0] > 0
    assert out[0] == out[1]


def test_recurrentgemma_serving_slice_matches_reference(tmp_path):
    """The RecurrentGemma slice as a whole: ``chip_smoke.run_serving``
    (phase 5's routine) on the CPU at the float32 smoke config, against the
    JAX engine's greedy tokens for the same parameters and prompt.  The
    prompt (29) fits the window (32); the ring wraps at position 32,
    before the session is saved at token 5 (position 33)."""
    cs = _chip_smoke()
    jcfg, cfg = rg_configs()
    params = rg_numpy_params(cs, jcfg, seed=4)
    tokens = prompt(cfg.vocab, n=30, seed=8)
    want = JEngine(jcfg, params, batch=B, max_len=64).generate(
        {"inputs": jnp.asarray(tokens[:, :29])}, 12)
    out = cs.run_serving(
        cfg, params_from_numpy(cfg, params, device="cpu"), tokens,
        device="cpu", directory=tmp_path, max_len=64, steps=12, save_at=5,
        factor="0.5")
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))
    assert out["session_flushed_bytes"] > 0
    assert out["consistency_rel_err"] < 0.02
    assert len(out["step_ms"]) == 11


def test_serve_launcher_runs_recurrentgemma_on_the_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", RG_ARCH,
         "--smoke", "--device", "cpu", "--steps", "4", "--session",
         str(tmp_path / "s.bin")],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "generated token ids" in r.stdout and "session flushed" in r.stdout


# -- the MoE family: deepseek-v2 (MLA latent cache) and llama4-maverick ---------

MOE_ARCHS = ["deepseek-v2-236b", "llama4-maverick-400b-a17b"]


def moe_configs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_kill_and_resume_is_exact(tmp_path, arch):
    """Generate 14 tokens from a 13-token prompt (the tail merges at 16 and
    24); then prefill, steps, save at position 19, drop the engine, load
    into a fresh one, continue: the same tokens, and the same final cache
    bit for bit (MLA: the latent main and tail)."""
    cfg = get_config(arch, smoke=True)
    params = init_params(param_specs(cfg), 0, device="cpu")
    steps, save_at = 14, 7
    toks = prompt(cfg.vocab, n=13)
    store = SessionStore(tcore.Communicator(1), str(tmp_path / "sess.bin"),
                         init_cache_specs(cfg, B, MAX_LEN), factor="0.5")
    eng = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                 device="cpu")
    assert {v.shape[2] for k, v in eng.cache_specs.items()  # (reps, B, Tt, ..)
            if k.split("/")[-1] in TAIL_TO_MAIN} == {cfg.decode_tail}
    out_full = eng.generate({"inputs": toks}, steps)
    final = {k: v.clone() for k, v in eng.cache.items()}
    if cfg.attn_kind == "mla":
        assert {"g0/p0/ckv", "g0/p0/tckv", "g1/p0/kr"} <= set(final)
        assert not any(k.endswith("/k") for k in final)

    eng2 = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                  device="cpu")
    seq = [eng2.prefill({"inputs": toks})]
    for _ in range(save_at - 1):
        seq.append(eng2.step(seq[-1]))
    eng2.generated = list(seq)
    assert eng2.pos == 19
    assert eng2.save_session() > 0
    del eng2
    eng3 = Engine(cfg, params, batch=B, max_len=MAX_LEN, session=store,
                  device="cpu")
    eng3.load_session()
    assert eng3.pos == 19
    for _ in range(steps - save_at):
        seq.append(eng3.step(seq[-1]))
    np.testing.assert_array_equal(np.stack(seq, axis=1), out_full)
    assert all(torch.equal(v, eng3.cache[k]) for k, v in final.items())
    store.free()


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("factor", [None, "0.5"])
def test_moe_session_files_byte_identical(tmp_path, arch, factor):
    """The same cache (bf16 bits: MLA's latent ``ckv``/``kr`` and tails,
    or llama4's k/v), pos and tokens saved by both packages: the same
    flushed byte count and the same window file."""
    jcfg, cfg = moe_configs(arch, "bfloat16")
    rng = np.random.default_rng(13)
    jspecs, specs = j_cache_specs(jcfg, B, MAX_LEN), init_cache_specs(
        cfg, B, MAX_LEN)
    assert sorted(jspecs) == sorted(specs)
    bits = {k: rng.integers(0, 1 << 15, size=s.shape, dtype=np.uint16)
            for k, s in specs.items()}
    toks = rng.integers(0, cfg.vocab, size=B * 7).astype(np.int32)
    out = []
    for name, store_cls, comm, spec, cache in (
            ("ref.bin", JSessionStore, jcore.Communicator(1), jspecs,
             {k: jnp.asarray(b.view(ml_dtypes.bfloat16))
              for k, b in bits.items()}),
            ("port.bin", SessionStore, tcore.Communicator(1), specs,
             tree_from_numpy({k: b.view(ml_dtypes.bfloat16)
                              for k, b in bits.items()}, device="cpu"))):
        store = store_cls(comm, str(tmp_path / name), spec, factor=factor)
        flushed = store.save(cache, PROMPT + 7, toks)
        store.free()
        out.append((flushed, (tmp_path / name).read_bytes()))
    assert out[0][0] > 0
    assert out[0] == out[1]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serving_slice_matches_reference(tmp_path, arch):
    """The MoE slice as a whole: ``chip_smoke.run_serving`` (phase 9's
    routine) on the CPU at the float32 smoke config against the JAX
    engine's greedy tokens for the same parameters and prompt: a prompt of
    13, 12 steps across merges at 16 and 24, the session saved at token 5;
    the consistency reading at tests/test_models.py's MoE limit."""
    cs = _chip_smoke()
    jcfg, cfg = moe_configs(arch)
    params = numpy_params(jcfg, seed=4)
    tokens = prompt(cfg.vocab, n=14, seed=8)
    want = JEngine(jcfg, params, batch=B, max_len=MAX_LEN).generate(
        {"inputs": jnp.asarray(tokens[:, :13])}, 12)
    out = cs.run_serving(
        cfg, params_from_numpy(cfg, params, device="cpu"), tokens,
        device="cpu", directory=tmp_path, max_len=MAX_LEN, steps=12,
        save_at=5, factor="0.5", consistency_limit=0.08)
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))
    assert out["session_flushed_bytes"] > 0
    assert len(out["step_ms"]) == 11
    n_moe = sum(r * p.count("moe") for r, p in cfg.groups())
    assert out["routing"]["of"] == B * n_moe  # the compared token's sets


def test_serve_launcher_runs_deepseek_on_the_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "deepseek-v2-236b", "--smoke", "--device", "cpu", "--steps", "4",
         "--session", str(tmp_path / "s.bin")],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "generated token ids" in r.stdout and "session flushed" in r.stdout
