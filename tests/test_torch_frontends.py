"""The frontends against the JAX package: LLaVA's projected patch prefix
(llava-next-mistral-7b) and Whisper's encoder-decoder (whisper-base).

Smoke configs (LLaVA: 8 patch positions; Whisper: 2 encoder and 2
decoder layers over 16 frames), the reference's ``init_params`` as numpy
parameters for both packages, seeded numpy inputs.  Frames are exactly
``enc_len`` long: the reference's decode attends every cached encoder
slot, so a shorter input would compare that, not the model.  Prompt
lengths (plus LLaVA's 8 patch positions) are not multiples of
``decode_tail`` (8), where the reference's engine corrupts its cache
(ROADMAP queue C).

Limits: ``sinusoidal_positions`` 1e-6; the encoder 1e-5 (float32);
prefill and per-step decode logits 1e-4 relative in a float32 config
(float32 caches on both sides) and 2e-2 in bf16; greedy tokens equal in
float32; the cross-attention cache after prefill at 1e-6 relative in
float32 (2e-2 in bf16); the loss at 1e-5 relative and its
gradients at 1e-5 of each tensor's largest |g| (float32, parameters
too); session files byte for byte.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as j_get_config
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import init_cache_specs as j_cache_specs
from repro.models import init_params as j_init_params
from repro.models import lm as jlm
from repro.models import make_decode_fn as j_decode_fn
from repro.models import make_loss_fn as j_make_loss_fn
from repro.models import make_prefill_fn as j_prefill_fn
from repro.models import param_specs as j_param_specs
from repro.models.layers import sinusoidal_positions as j_sinusoidal
from repro.serve import Engine as JEngine
from repro.serve import SessionStore as JSessionStore
import repro_torch.core as tcore
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, to_host_f32, tree_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.models import (cast_params, init_cache_specs, lm,
                                make_decode_fn, make_loss_fn, make_prefill_fn,
                                param_specs)
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.serve import Engine, SessionStore

VLM, AUDIO = "llava-next-mistral-7b", "whisper-base"
FRONTENDS = [VLM, AUDIO]
B = 2


def configs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def numpy_params(jcfg, seed=1):
    return {k: np.asarray(v) for k, v in
            j_init_params(j_param_specs(jcfg),
                          jax.random.PRNGKey(seed)).items()}


def prompt(cfg, n, seed=2):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(B, n)).astype(np.int32)


def extras(cfg, seed=3):
    """The frontend's inputs: patches (B, img_tokens, D) or frames (B,
    enc_seq, D), normal float32 from numpy."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vlm_stub":
        return {"patches": rng.standard_normal(
            (B, cfg.img_tokens, cfg.d_model)).astype(np.float32)}
    return {"frames": rng.standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}


def t(a):
    return torch.from_numpy(np.array(a))


def rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(1e-6, np.abs(b).max()))


def img(cfg):
    return cfg.img_tokens if cfg.frontend == "vlm_stub" else 0


def enc_len(cfg):
    return cfg.enc_seq if cfg.is_encdec else 0


# -- specs --------------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTENDS)
def test_param_and_cache_specs_match_reference(arch):
    """Names, shapes, dtypes, logical axes and init kinds, full size and
    smoke; the cache specs with and without an encoder context, in the
    reference's order (a session window's layout follows it)."""
    for smoke in (False, True):
        jcfg, cfg = j_get_config(arch, smoke=smoke), get_config(arch,
                                                                smoke=smoke)
        want, got = j_param_specs(jcfg), param_specs(cfg)
        assert sorted(got) == sorted(want)
        for k, s in got.items():
            w = want[k]
            assert (s.shape, s.dtype, s.axes, s.init) == (
                w.shape, jnp.dtype(w.dtype).name, w.axes, w.init), k
        for enc in (0, 24):
            want = j_cache_specs(jcfg, 3, 20, enc)
            got = init_cache_specs(cfg, 3, 20, enc)
            assert list(got) == list(want)
            for k, s in got.items():
                assert (s.shape, s.dtype, s.axes) == (
                    want[k].shape, jnp.dtype(want[k].dtype).name,
                    want[k].axes), k
    whisper = param_specs(get_config(AUDIO))
    assert {"enc_norm", "enc/g0/p0/wq", "g0/p0/normx", "g0/p0/x_wo"} <= set(
        whisper)
    assert whisper["enc/g0/p0/wq"].shape[0] == 6
    assert param_specs(get_config(VLM))["mm_proj"].shape == (4096, 4096)
    xk = init_cache_specs(get_config(AUDIO), 4, 448, 1500)["g0/p0/xk"]
    assert xk.shape == (6, 4, 1500, 8, 64)


def test_sinusoidal_positions_match_reference():
    pos = np.arange(0, 3000, 7)
    for d in (64, 512):
        want = np.asarray(j_sinusoidal(jnp.asarray(pos), d))
        got = sinusoidal_positions(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_encoder_matches_reference():
    """``_encode`` (float32): sinusoidal positions, two full-attention
    blocks (the kernel's plain version here) and ``enc_norm`` over 16
    frames; the training path (blockwise attention) gives the same."""
    jcfg, cfg = configs(AUDIO)
    params = numpy_params(jcfg)
    frames = extras(cfg)["frames"]
    want = np.asarray(jlm._encode(jcfg, jlm._cast_params(
        jcfg, {k: jnp.asarray(v) for k, v in params.items()}),
        jnp.asarray(frames)))
    tp = cast_params(cfg, params_from_numpy(cfg, params, device="cpu"))
    for train in (False, True):
        got = lm._encode(cfg, tp, t(frames), train=train)
        assert got.shape == (B, cfg.enc_seq, cfg.d_model)
        assert rel_err(to_host_f32(got.detach()), want) < 1e-5, train


# -- prefill and decode -------------------------------------------------------

def _f32_cache(specs, lib):
    return {k: lib.zeros(v.shape, dtype=lib.float32) for k, v in specs.items()}


def _both(arch, dtype, S, steps, seed=1):
    """Prefill of S text tokens (after a VLM's patches) and ``steps``
    decode steps through both packages' factories: (reference logits,
    port logits, reference cache, port cache) after prefill."""
    jcfg, cfg = configs(arch, dtype)
    params = numpy_params(jcfg, seed)
    toks = prompt(cfg, S + steps)
    ex = extras(cfg)
    T = img(cfg) + S + steps + 1
    jcs = j_cache_specs(jcfg, B, T, enc_len(cfg))
    cs = init_cache_specs(cfg, B, T, enc_len(cfg))
    if dtype == "float32":
        jcache, cache = _f32_cache(jcs, jnp), _f32_cache(cs, torch)
    else:
        jcache = {k: jnp.zeros(v.shape, jnp.dtype(v.dtype))
                  for k, v in jcs.items()}
        cache = {k: torch.zeros(v.shape, dtype=getattr(torch, v.dtype))
                 for k, v in cs.items()}
    jl, jcache = j_prefill_fn(jcfg)(
        params, {"inputs": jnp.asarray(toks[:, :S]),
                 **{k: jnp.asarray(v) for k, v in ex.items()}}, jcache)
    jprefilled = {k: np.asarray(v.astype(jnp.float32))
                  for k, v in jcache.items()}
    jout = [np.asarray(jl, np.float32)]
    jdec = j_decode_fn(jcfg)
    pos0 = img(cfg) + S
    for i in range(steps):
        jl, jcache = jdec(params, jcache,
                          jnp.asarray(toks[:, S + i:S + i + 1]),
                          jnp.int32(pos0 + i))
        jout.append(np.asarray(jl, np.float32))
    tp = cast_params(cfg, params_from_numpy(cfg, params, device="cpu"))
    tl, cache = make_prefill_fn(cfg)(
        tp, {"inputs": t(toks[:, :S]).long(),
             **{k: t(v) for k, v in ex.items()}}, cache)
    prefilled = {k: to_host_f32(v) for k, v in cache.items()}
    tout = [to_host_f32(tl)]
    dec = make_decode_fn(cfg)
    for i in range(steps):
        tl, cache = dec(tp, cache, t(toks[:, S + i:S + i + 1]).long(),
                        pos0 + i)
        tout.append(to_host_f32(tl))
    return jout, tout, jprefilled, prefilled


@pytest.mark.parametrize("arch", FRONTENDS)
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_prefill_decode_logits_match_reference(arch, dtype, tol):
    """A 13-token prompt (LLaVA: 8 patch positions before it, 21 in all)
    and four decode steps: every step's logits, and the cross-attention
    cache after prefill (float32 at 1e-6; in bf16 at the logits' limit:
    the encoder's attention rounds in another order than the reference's
    online-softmax scan, so its bf16 output and the keys and values
    made from it differ by bf16 ulps)."""
    jout, tout, jcache, cache = _both(arch, dtype, 13, 4)
    for i, (a, b) in enumerate(zip(tout, jout)):
        assert a.shape == b.shape == (B, 1, 512)
        assert rel_err(a, b) < tol, (i, rel_err(a, b))
    xkv = [k for k in cache if k.split("/")[-1] in ("xk", "xv")]
    assert bool(xkv) == (arch == AUDIO)
    for k in xkv:
        limit = 1e-6 if dtype == "float32" else tol
        assert rel_err(cache[k], jcache[k]) < limit, k


@pytest.mark.parametrize("arch", FRONTENDS)
def test_greedy_tokens_match_reference(arch):
    """Float32 config: 12 greedy tokens from an 11-token prompt through
    both engines; the tail merges at positions 16 and 24 (LLaVA: 24 and
    32, its decode starting at 8 + 11 = 19)."""
    jcfg, cfg = configs(arch)
    params = numpy_params(jcfg, seed=4)
    toks = prompt(cfg, 11, seed=8)
    ex = extras(cfg)
    max_len = 40
    want = JEngine(jcfg, params, batch=B, max_len=max_len,
                   enc_len=enc_len(cfg)).generate(
        {"inputs": jnp.asarray(toks),
         **{k: jnp.asarray(v) for k, v in ex.items()}}, 12)
    eng = Engine(cfg, params_from_numpy(cfg, params, device="cpu"), batch=B,
                 max_len=max_len, enc_len=enc_len(cfg), device="cpu")
    got = eng.generate({"inputs": toks, **ex}, 12)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert eng.pos == img(cfg) + 11 + 11


def test_vlm_decode_positions_count_the_patches():
    """After a LLaVA prefill the engine's position counts the patches
    (8 + 13 = 21, not a multiple of decode_tail): decode there agrees with
    prefill(14)'s last logits at 1e-4 (float32, a float32 cache), and a
    decode step at the text's own position (13) instead does not."""
    jcfg, cfg = configs(VLM)
    params = params_from_numpy(cfg, numpy_params(jcfg), device="cpu")
    toks = prompt(cfg, 14)
    ex = extras(cfg)
    eng = Engine(cfg, params, batch=B, max_len=32, device="cpu")
    eng.cache = {k: v.float() for k, v in eng.cache.items()}  # no rounding
    eng.prefill({"inputs": toks[:, :13], **ex})
    assert eng.pos == cfg.img_tokens + 13 == 21
    assert eng.pos % cfg.decode_tail
    good = to_host_f32(eng.decode_logits(toks[:, 13:]))
    full = to_host_f32(make_prefill_fn(cfg)(
        eng.params, {"inputs": t(toks).long(), **{k: t(v) for k, v in
                                                  ex.items()}},
        eng.cache)[0])
    assert rel_err(good, full) < 1e-4
    eng.prefill({"inputs": toks[:, :13], **ex})
    eng.pos = 13
    wrong = to_host_f32(eng.decode_logits(toks[:, 13:]))
    assert rel_err(wrong, full) > 1e-2


def test_engine_checks_frontend_inputs():
    """The engine takes a VLM's patches and an encoder-decoder model's
    frames of exactly its shape, and wants an encoder context."""
    cfg = get_config(AUDIO, smoke=True)
    params = params_from_numpy(cfg, numpy_params(j_get_config(
        AUDIO, smoke=True)), device="cpu")
    with pytest.raises(ValueError, match="enc_len"):
        Engine(cfg, params, batch=B, max_len=16, device="cpu")
    eng = Engine(cfg, params, batch=B, max_len=16, enc_len=16, device="cpu")
    toks = prompt(cfg, 5)
    with pytest.raises(ValueError, match="frames"):
        eng.prefill({"inputs": toks})
    with pytest.raises(ValueError, match="frames must be"):
        eng.prefill({"inputs": toks,
                     "frames": np.zeros((B, 15, 64), np.float32)})
    vcfg = get_config(VLM, smoke=True)
    veng = Engine(vcfg, params_from_numpy(vcfg, numpy_params(j_get_config(
        VLM, smoke=True)), device="cpu"), batch=B, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="prompt length 17"):
        veng.prefill({"inputs": prompt(vcfg, 9), **extras(vcfg)})


# -- training -----------------------------------------------------------------

@pytest.mark.parametrize("arch", FRONTENDS)
def test_loss_and_grads_match_reference(arch):
    """``make_loss_fn`` in float32 (parameters too) on a ``SyntheticLM``
    batch (LLaVA: 8 patches + 16 text positions; Whisper: 24 frames and
    tokens) against ``jax.value_and_grad`` of the reference's: the loss
    at 1e-5 relative, each gradient within 1e-5 of its tensor's largest
    |g| (``mm_proj``, ``enc/*`` and the cross-attention's included)."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               dtype="float32", param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              param_dtype="float32")
    params = numpy_params(jcfg)
    b = JSyntheticLM(jcfg, batch=2, seq=24, seed=3).batch_at(0)
    batch = {k: v[0] for k, v in b.items()}
    (want, jm), want_g = jax.value_and_grad(
        j_make_loss_fn(jcfg), has_aux=True)(params, batch)
    leaves = {k: v.requires_grad_(True)
              for k, v in params_from_numpy(cfg, params, "cpu").items()}
    loss, metrics = make_loss_fn(cfg)(
        leaves, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert float(metrics["ntok"]) == float(jm["ntok"]) == 2 * (
        24 - img(cfg) - 1)
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    special = {"mm_proj"} if arch == VLM else {"enc/g0/p0/wq", "g0/p0/x_wk",
                                               "enc_norm"}
    assert special <= set(grads)
    for k, g in grads.items():
        wg = np.asarray(want_g[k])
        assert np.abs(g.numpy() - wg).max() <= 1e-5 * np.abs(wg).max(), k


# -- sessions -----------------------------------------------------------------

def test_whisper_engine_kill_and_resume_is_exact(tmp_path):
    """Generate 14 tokens from a 13-token prompt over 16 frames; then
    prefill, steps, save at position 19, a fresh engine on the same store,
    load, continue: the same tokens, and the same final cache bit for bit
    (the cross-attention cache included); the reference's engine gives
    the same tokens in float32."""
    jcfg, cfg = configs(AUDIO)
    nparams = numpy_params(jcfg)
    params = params_from_numpy(cfg, nparams, device="cpu")
    steps, save_at, max_len = 14, 7, 32
    toks = prompt(cfg, 13)
    ex = extras(cfg)
    store = SessionStore(tcore.Communicator(1), str(tmp_path / "sess.bin"),
                         init_cache_specs(cfg, B, max_len, cfg.enc_seq),
                         factor="0.5")
    eng = Engine(cfg, params, batch=B, max_len=max_len, enc_len=cfg.enc_seq,
                 session=store, device="cpu")
    out_full = eng.generate({"inputs": toks, **ex}, steps)
    final = {k: v.clone() for k, v in eng.cache.items()}
    assert {"g0/p0/xk", "g0/p0/xv"} <= set(final)

    eng2 = Engine(cfg, params, batch=B, max_len=max_len, enc_len=cfg.enc_seq,
                  session=store, device="cpu")
    seq = [eng2.prefill({"inputs": toks, **ex})]
    for _ in range(save_at - 1):
        seq.append(eng2.step(seq[-1]))
    eng2.generated = list(seq)
    assert eng2.pos == 19
    assert eng2.save_session() > 0
    del eng2
    eng3 = Engine(cfg, params, batch=B, max_len=max_len, enc_len=cfg.enc_seq,
                  session=store, device="cpu")
    eng3.load_session()
    assert eng3.pos == 19
    for _ in range(steps - save_at):
        seq.append(eng3.step(seq[-1]))
    np.testing.assert_array_equal(np.stack(seq, axis=1), out_full)
    assert all(torch.equal(v, eng3.cache[k]) for k, v in final.items())
    store.free()
    want = JEngine(jcfg, nparams, batch=B, max_len=max_len,
                   enc_len=cfg.enc_seq).generate(
        {"inputs": jnp.asarray(toks),
         **{k: jnp.asarray(v) for k, v in ex.items()}}, steps)
    np.testing.assert_array_equal(out_full, np.asarray(want))


@pytest.mark.parametrize("factor", [None, "0.5"])
def test_whisper_session_files_byte_identical(tmp_path, factor):
    """The same Whisper cache (bf16 bits: self-attention main and tail,
    the cross-attention ``xk``/``xv``), pos and tokens saved by both
    packages' stores: the same flushed byte count and the same window
    file."""
    jcfg, cfg = configs(AUDIO, "bfloat16")
    rng = np.random.default_rng(13)
    jspecs = j_cache_specs(jcfg, B, 32, cfg.enc_seq)
    specs = init_cache_specs(cfg, B, 32, cfg.enc_seq)
    assert list(jspecs) == list(specs)
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
        flushed = store.save(cache, 13 + 7, toks)
        store.free()
        out.append((flushed, (tmp_path / name).read_bytes()))
    assert out[0][0] > 0
    assert out[0] == out[1]


@pytest.mark.parametrize("arch", FRONTENDS)
def test_synthetic_batches_feed_the_trainer(arch):
    """``SyntheticLM`` batches (byte-equal to the reference's) through the
    port's ``Trainer`` on the CPU: every key reaches the loss, the losses
    are finite and fall on a fixed batch."""
    from repro_torch.train import AdamWConfig, TrainConfig, Trainer
    cfg = get_config(arch, smoke=True)
    fixed = SyntheticLM(cfg, batch=2, seq=24, seed=0).batch_at(0)
    assert set(fixed) == {"inputs", "targets",
                          "patches" if arch == VLM else "frames"}

    class Fixed:
        def __iter__(self):
            while True:
                yield fixed

    opt = AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    tr = Trainer(cfg, opt, TrainConfig(steps=4, log_every=0), device="cpu")
    tr.run(iter(Fixed()))
    losses = [m["loss"] for m in tr.metrics_log]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    tr.close()


# -- the slice as a whole -----------------------------------------------------

@pytest.mark.parametrize("arch", FRONTENDS)
def test_serving_slice_matches_reference(tmp_path, arch):
    """``chip_smoke.run_serving`` (phase 9e's and 9f's routine: generate;
    then prefill, steps, for Whisper a session saved at token 5 and
    reopened, steps; the consistency reading) on the CPU at the float32
    smoke config, with the frontend's inputs, against the JAX engine's
    greedy tokens for the same parameters, prompt and inputs: a prompt of
    13 (LLaVA: 21 positions), 12 steps across tail merges."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    jcfg, cfg = configs(arch)
    params = numpy_params(jcfg, seed=4)
    tokens = prompt(cfg, 14, seed=8)
    ex = extras(cfg)
    want = JEngine(jcfg, params, batch=B, max_len=40,
                   enc_len=enc_len(cfg)).generate(
        {"inputs": jnp.asarray(tokens[:, :13]),
         **{k: jnp.asarray(v) for k, v in ex.items()}}, 12)
    out = cs.run_serving(
        cfg, params_from_numpy(cfg, params, device="cpu"), tokens,
        device="cpu", directory=tmp_path, max_len=40, steps=12,
        save_at=5 if arch == AUDIO else None, factor="0.5",
        extra={k: t(v) for k, v in ex.items()})
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))
    assert ("session_flushed_bytes" in out) == (arch == AUDIO)
    assert out["resumed_equal"]["tokens"] and len(out["step_ms"]) == 11
    # the cache is bf16 even in a float32 config: decode reads rounded k/v
    assert out["consistency_rel_err"] < 0.02
