"""The port's CheckpointManager against the JAX package's.

Both managers get the same trees (numpy from a seed; the port's as CPU
tensors, bf16 as ``torch.bfloat16`` with the same bits, the reference's as
``ml_dtypes.bfloat16``) saved at the same steps.  The window files
``ckpt_a.bin`` / ``ckpt_b.bin``, ``manifest.json`` and
``manifest.prev.json`` must be byte-identical, and every save must flush
the same bytes.  The reference's own checkpoint tests
(``tests/test_ckpt_offload.py``: double buffering, selective and async
saves, the torn-manifest fallback, reopening after a crash) run on the
port, and a checkpoint written by the JAX ``Trainer`` restores into the
port's, bit for bit.
"""

import dataclasses
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JManager
from repro.configs import get_config as j_get_config
from repro.core import Communicator as JComm
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import init_params as j_init_params
from repro.models import param_specs as j_param_specs
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.core import Communicator
from repro_torch.train import AdamWConfig, TrainConfig, Trainer

FILES = ("ckpt_a.bin", "ckpt_b.bin", "manifest.json", "manifest.prev.json")


def _specs(bf16):
    """A fused-mode tree's kinds of slot: float32 params and moments, a
    0-d int32 step, a bf16 (offload-mode) parameter, a ragged size."""
    return {"w": ((64, 40), np.float32), "opt_m/w": ((64, 40), np.float32),
            "norm": ((1500,), np.float32), "opt_step": ((), np.int32),
            "emb": ((3, 1111), bf16)}


def _trees(n=3, seed=0):
    """``n`` numpy trees (bf16 as uint16 bits); tree i+1 changes one row
    of ``w``, all of ``opt_m/w`` and the step, and keeps the rest."""
    rng = np.random.default_rng(seed)
    t = {"w": rng.standard_normal((64, 40)).astype(np.float32),
         "opt_m/w": rng.standard_normal((64, 40)).astype(np.float32),
         "norm": rng.standard_normal(1500).astype(np.float32),
         "opt_step": np.asarray(1, np.int32),
         "emb": rng.integers(0, 1 << 16, (3, 1111)).astype(np.uint16)}
    out = [t]
    for i in range(1, n):
        t = {k: v.copy() for k, v in t.items()}
        t["w"][i * 7] += 1.0
        t["opt_m/w"] *= 0.5
        t["opt_step"] = np.asarray(i + 1, np.int32)
        out.append(t)
    return out


def _as_ref(tree):
    return {k: (v.view(ml_dtypes.bfloat16) if k == "emb" else v)
            for k, v in tree.items()}


def _as_port(tree):
    return {k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                if k == "emb" else torch.from_numpy(v.copy()))
            for k, v in tree.items()}


def _run(tmp_path, name, mode, **kw):
    """Save every tree of ``_trees()`` at steps 1, 2, 3 (windows a, b, a:
    the third save is a selective one) with each package; returns the
    flushed bytes per save and the directory."""
    d = tmp_path / name
    if name == "ref":
        cm = JManager(str(d), JComm(1), _specs(ml_dtypes.bfloat16), **kw)
        trees = [_as_ref(t) for t in _trees()]
    else:
        cm = CheckpointManager(str(d), Communicator(1),
                               _specs(torch.bfloat16), **kw)
        trees = [_as_port(t) for t in _trees()]
    flushed = []
    for step, tree in enumerate(trees, 1):
        if mode == "async":
            cm.save_async(step, tree)
            cm.wait()
            flushed.append(cm.bytes_flushed_total - sum(flushed))
        else:
            flushed.append(cm.save(step, tree))
    res = cm.restore()
    cm.close()
    return flushed, d, res


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("double_buffer", [True, False])
def test_files_and_manifests_byte_identical(tmp_path, mode, double_buffer):
    want, dref, rref = _run(tmp_path, "ref", mode, double_buffer=double_buffer)
    got, dport, rport = _run(tmp_path, "port", mode,
                             double_buffer=double_buffer)
    assert got == want
    assert got[2] < got[0]  # the third save is selective
    for f in FILES:
        if (dref / f).exists() or (dport / f).exists():
            assert (dport / f).read_bytes() == (dref / f).read_bytes(), f
    manifest = json.loads((dport / "manifest.json").read_text())
    assert manifest["layout"]["slots"]["emb"]["dtype"] == "<V2"
    assert manifest["layout"]["slots"]["w"]["dtype"] == "<f4"
    assert rport.step == rref.step == 3
    for k, v in rref.tree.items():
        assert rport.tree[k].tobytes() == np.asarray(v).tobytes(), k


def test_device_tensors_stage_as_their_bytes(tmp_path):
    """A tree of tensors and the same tree as numpy arrays (bf16 as bits)
    write the same files; bf16 slots refuse float32 arrays."""
    files = []
    for name, tree in (("t", _as_port(_trees(1)[0])), ("n", _trees(1)[0])):
        cm = CheckpointManager(str(tmp_path / name), Communicator(1),
                               _specs("bfloat16"))
        cm.save(1, tree)
        cm.close()
        files.append((tmp_path / name / "ckpt_a.bin").read_bytes())
    assert files[0] == files[1]
    cm = CheckpointManager(str(tmp_path / "e"), Communicator(1),
                           _specs("bfloat16"))
    bad = dict(_trees(1)[0], emb=np.zeros((3, 1111), np.float32))
    with pytest.raises(TypeError, match="bfloat16"):
        cm.save(1, bad)
    cm.close()


# -- the reference's checkpoint tests, on the port ----------------------------

def test_ckpt_save_restore_and_double_buffer(tmp_path):
    specs = {"w": ((8, 8), np.float32), "s": ((), np.int32)}
    cm = CheckpointManager(str(tmp_path), Communicator(1), specs)
    cm.save(1, {"w": torch.ones(8, 8), "s": np.int32(1)})
    cm.save(2, {"w": torch.full((8, 8), 2.0), "s": np.int32(2)})
    r = cm.restore()
    assert r.step == 2 and (r.tree["w"] == 2).all()
    # torn write: corrupt the latest target on disk, then restart cold --
    # the fresh manager must CRC-fail the newest manifest and fall back
    with open(cm._manifest_path()) as f:
        target = json.load(f)["target"]
    with open(os.path.join(str(tmp_path), f"ckpt_{target}.bin"), "r+b") as f:
        f.seek(0)
        f.write(b"\xde\xad\xbe\xef" * 8)
    cm2 = CheckpointManager.open_for_restore(str(tmp_path), Communicator(1),
                                             specs)
    r2 = cm2.restore()
    assert r2 is not None and r2.fell_back and r2.step == 1
    assert (r2.tree["w"] == 1).all()
    cm2.close()


def test_ckpt_selective_sync(tmp_path):
    specs = {"big": ((1 << 16,), np.float32), "tiny": ((4,), np.float32)}
    cm = CheckpointManager(str(tmp_path), Communicator(1), specs,
                           double_buffer=False)
    big = torch.from_numpy(
        np.random.default_rng(0).standard_normal(1 << 16).astype(np.float32))
    f1 = cm.save(1, {"big": big, "tiny": torch.zeros(4)})
    # change only the tiny slot: selective sync flushes ~1 page, not 256 KiB
    f2 = cm.save(2, {"big": big, "tiny": torch.ones(4)})
    assert f2 <= 8192 < f1
    assert [r["bytes"] for r in cm.records] == [f1, f2]
    cm.close()


def test_ckpt_async_overlap(tmp_path):
    cm = CheckpointManager(str(tmp_path), Communicator(1),
                           {"w": ((256, 256), np.float32)})
    w = torch.ones(256, 256)
    cm.save_async(1, {"w": w})
    w.fill_(7.0)  # the staged copy is the manager's: the save keeps ones
    cm.wait()
    r = cm.restore()
    assert r.step == 1 and (r.tree["w"] == 1).all()
    rec = cm.records[0]
    assert rec["bytes"] == 256 * 256 * 4 and rec["flush_ms"] >= 0
    cm.close()


def test_crash_restart_reopens_files(tmp_path):
    specs = {"w": ((16,), np.float32)}
    cm = CheckpointManager(str(tmp_path), Communicator(1), specs)
    cm.save(5, {"w": torch.full((16,), 5.0)})
    del cm  # "crash": no close
    cm2 = CheckpointManager.open_for_restore(str(tmp_path), Communicator(1),
                                             specs)
    r = cm2.restore()
    assert r.step == 5 and (r.tree["w"] == 5).all()
    cm2.close()


def test_replication_refused_naming_resilience(tmp_path):
    """Once refused, ``replication=2`` now works as the reference's: both
    saves mirror to the replica before their manifests commit, and with the
    saving rank dead ``restore`` serves the newest step from the replica;
    files and the restored tree equal the reference manager's."""
    spec = {"w": ((2048,), np.float32)}
    w = np.random.default_rng(0).standard_normal(2048).astype(np.float32)
    got = {}
    for name, comm, cls in (("ref", JComm(2), JManager),
                            ("port", Communicator(2), CheckpointManager)):
        d = tmp_path / name
        cm = cls(str(d), comm, spec, replication=2)
        cm.save(1, {"w": w})
        cm.save(2, {"w": w + 1})
        comm.mark_dead(0)
        r = cm.restore()
        got[name] = (r.step, r.tree["w"].tobytes())
        comm.mark_alive(0)
        cm.close()
        comm.close()
        got[name + "_files"] = {p.name: p.read_bytes()
                                for p in sorted(d.iterdir()) if "bin" in p.name}
    assert got["port"] == got["ref"] == (2, (w + 1).tobytes())
    assert got["port_files"] == got["ref_files"]
    assert "ckpt_a.bin.rep1.0" in got["port_files"]


# -- a checkpoint of the JAX Trainer, restored by the port's --------------------

@pytest.mark.parametrize("mode", ["fused", "offload"])
def test_jax_trainer_checkpoint_restores_into_port(tmp_path, mode):
    jcfg = dataclasses.replace(j_get_config("internlm2-1.8b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True),
                              dtype="float32")
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    ck = str(tmp_path / "ck")
    params = {k: np.asarray(v) for k, v in j_init_params(
        j_param_specs(jcfg), jax.random.PRNGKey(3)).items()}
    ds = JSyntheticLM(jcfg, batch=2, seq=16, seed=1)
    it = (ds.batch_at(i) for i in range(10))
    jtr = JTrainer(jcfg, JAdamWConfig(**opt), JTrainConfig(
        steps=2, log_every=0, mode=mode, ckpt_dir=ck, ckpt_every=2,
        ckpt_async=False))
    jp, jo = jtr.run(it, params={k: jax.numpy.asarray(v)
                                 for k, v in params.items()})
    jtr.close()
    tr = Trainer(cfg, AdamWConfig(**opt), TrainConfig(
        steps=2, log_every=0, mode=mode, ckpt_dir=ck, ckpt_every=2),
        device="cpu")
    p, o = tr.run(iter(()), params=params_from_numpy(cfg, params, "cpu"))
    assert tr.restored_step == 2 and tr.metrics_log == []
    got = tree_to_numpy(p)
    for k, v in jp.items():
        assert got[k].tobytes() == np.asarray(v).tobytes(), k
    if mode == "fused":
        for part in ("m", "v"):
            for k, v in jo[part].items():
                assert o[part][k].numpy().tobytes() == \
                    np.asarray(v).tobytes(), (part, k)
        assert o["step"].dtype == torch.int32 and int(o["step"]) == 2
    tr.close()
