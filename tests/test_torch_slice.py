"""The storage-window slice as a whole, against the JAX package.

``chip_smoke.py`` drives the port's main path -- ``OutOfCoreAdamW`` over the
internlm2-1.8b parameter tree, masters on the device, three
``sync_masters_from_device`` calls -- at full width on the card.  Here the
same routine runs on the CPU at a small size (1 layer, d_model 128, vocab
512, narrower heads and MLP), beside the same steps through ``repro`` with
the same masters and changes: after each sync the optimizer window files
must be byte-identical and the flushed bytes equal.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as j_get_config
from repro.models.lm import param_specs as j_param_specs
from repro.train.offload_opt import OutOfCoreAdamW as JAdamW
from repro.train.optimizer import AdamWConfig as JConfig
from repro_torch.configs import get_config
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.models import param_specs

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(d_model=128, vocab=512, d_ff=512, n_heads=4, n_kv_heads=2,
             head_dim=32)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_main_path_matches_reference(tmp_path, chip_smoke):
    cfg = chip_smoke.smoke_config(1, **SMALL)
    shapes = {k: s.shape for k, s in param_specs(cfg).items()}
    spec = {k: (s, np.float32) for k, s in shapes.items()}
    masters0 = chip_smoke.make_masters(cfg, 0, "cpu")
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    jo = JAdamW(jcore.Communicator(1), spec, str(tmp_path / "ref"), JConfig())
    jm = {k: v.numpy().copy() for k, v in masters0.items()}
    jo.initialize(jm)
    jo.state.sync()
    jsnap = {k: v.copy() for k, v in jm.items()}
    ref_flushed = []

    def on_sync(i, change, masters, snapshot):
        chip_smoke.apply_mutation(jm, change)
        ref_flushed.append(jo.sync_masters_from_device(jm, jsnap, impl="ref"))
        for k in change:
            jsnap[k] = jm[k].copy()
        port = (tmp_path / "port" / "optstate.bin").read_bytes()
        ref = (tmp_path / "ref" / "optstate.bin").read_bytes()
        assert port == ref, f"window files differ after sync {i + 1}"

    out = chip_smoke.run_main_path(cfg, device="cpu",
                                   directory=tmp_path / "port", seed=0,
                                   on_sync=on_sync, log=lambda *_: None)
    jo.free()
    flushed = [r["flushed_bytes"] for r in out["records"]]
    assert flushed == ref_flushed
    assert flushed[0] > 0 and flushed[1] > 0 and flushed[2] == 0
    assert out["nparams"] == sum(int(np.prod(s)) for s in shapes.values())


def test_mp_phase_at_smoke_widths(tmp_path, chip_smoke):
    """Phase 7's routine at the small size on the CPU: the main path into
    a worker-owned window flushes what phase 2 flushes, one control message
    per sync; the shard groups, the DHT and MapReduce give byte-identical
    files under inproc and mp (checked inside, exact)."""
    cfg = chip_smoke.smoke_config(1, **SMALL)
    (tmp_path / "p2").mkdir()
    quiet = dict(log=lambda *_: None)
    phase2 = chip_smoke.run_main_path(cfg, device="cpu",
                                      directory=tmp_path / "p2", **quiet)
    out = chip_smoke.mp_phase(
        cfg, torch.device("cpu"), phase2, tmp_path / "mp",
        dht=dict(chip_smoke.MP_DHT, lv_entries=128),
        mr=dict(chip_smoke.MP_MR, tasks=6, words=300), **quiet)
    a = out["7a"]["syncs"]
    assert [s["flushed_bytes"] for s in a] \
        == [r["flushed_bytes"] for r in phase2["records"]]
    assert [s["messages"] for s in a] \
        == [[(0, "wsync")], [(0, "wsync")], [(0, "sync")]]
    assert a[0]["spans_logical_bytes"] == a[0]["flushed_bytes"]
    groups = chip_smoke.shard_groups(
        {k: s.shape for k, s in param_specs(cfg).items()})
    assert sorted(sum(groups, [])) == sorted(param_specs(cfg))
    b = out["7b"]
    assert b["files_identical"] == [f"shards.bin.{r}" for r in range(4)]
    assert [r["rank"] for r in b["mp"]["ranks"]] == [1, 2, 3]
    assert all(r["flushed_bytes"] > 0 for r in b["mp"]["ranks"])
    c = out["7c"]
    assert c["mp"]["inserts"] == c["inproc"]["inserts"] == int(4 * 128 * 0.8)
    assert c["files_identical"] == [f"dht.bin.{r}" for r in range(4)]
    d = out["7d"]
    assert d["mp"]["tasks"] == 6 and len(d["files_identical"]) == 8
    assert not (tmp_path / "mp").exists()


def test_param_specs_match_reference_internlm2_1p8b():
    """Names, shapes, dtypes, logical axes and init kinds of the full
    internlm2-1.8b tree equal the reference's."""
    ours = param_specs(get_config("internlm2-1.8b"))
    ref = j_param_specs(j_get_config("internlm2-1.8b"))
    assert sorted(ours) == sorted(ref)
    for k, s in ours.items():
        r = ref[k]
        assert (s.shape, s.dtype, s.axes, s.init) == \
            (r.shape, r.dtype, r.axes, r.init), k


def test_smoke_config_counts(chip_smoke):
    """The full-width depth-2 cut the card runs: 504,899,584 parameters in
    12 tensors."""
    cfg = chip_smoke.smoke_config()
    specs = param_specs(cfg)
    assert len(specs) == 12
    assert sum(int(np.prod(s.shape)) for s in specs.values()) == 504_899_584


def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, the script exits non-zero and
    prints no result line."""
    runs = [_run_smoke(ROOT)]
    (tmp_path / "chip_smoke.py").write_bytes(
        (ROOT / "chip_smoke.py").read_bytes())
    runs.append(_run_smoke(tmp_path))
    for r in runs:
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_convert_roundtrip_keeps_bits():
    """State crosses between the packages as numpy trees; bfloat16 goes
    through its bits both ways, never through float32."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 1 << 16, size=(3, 7), dtype=np.uint16)
    tree = {"b": bits.view(ml_dtypes.bfloat16),
            "f": rng.standard_normal((4, 5)).astype(np.float32),
            "i": rng.integers(-9, 9, size=11, dtype=np.int8)}
    tensors = tree_from_numpy(tree, device="cpu")
    assert tensors["b"].dtype == torch.bfloat16
    assert tensors["f"].dtype == torch.float32
    back = tree_to_numpy(tensors)
    assert back["b"].dtype == np.uint16 and (back["b"] == bits).all()
    for k in ("f", "i"):
        assert back[k].dtype == tree[k].dtype
        assert back[k].tobytes() == tree[k].tobytes()


def test_tensor_from_stored_keeps_one_host_copy():
    """A window read is already private: on the CPU the tensor shares it
    (a restored tree is held once), with shape and bits kept, bfloat16
    slots included."""
    from repro_torch.convert import tensor_from_stored
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tensor_from_stored(a, "float32", "cpu")
    assert t.data_ptr() == a.ctypes.data and t.shape == (2, 3)
    bits = np.array([0x3F80, 0xC000], dtype=np.uint16)  # 1.0, -2.0
    t = tensor_from_stored(bits, "bfloat16", "cpu")
    assert t.dtype == torch.bfloat16 and t.tolist() == [1.0, -2.0]
    assert t.data_ptr() == bits.ctypes.data
    s = tensor_from_stored(np.array(7, dtype=np.int32), "int32", "cpu")
    assert s.shape == () and int(s) == 7


def test_entry_points_default_to_cuda():
    """Allocating entry points default to the card and raise without one
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tree_from_numpy({"a": np.zeros(3, np.float32)})
