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

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
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


class _RefTwin:
    """Replays phase 8a's operations (``rep_shards``'s ``on_step``) on the
    JAX package's in-process 4-rank world; every returned value must equal
    the port's."""

    def __init__(self, directory: Path, size: int):
        self.comm = jcore.Communicator(4)
        self.win = jcore.Window.allocate(self.comm, size, info={
            "alloc_type": "storage",
            "storage_alloc_filename": str(directory / "shards.bin"),
            "storage_alloc_replication": "2"})
        self.seen = []

    def __call__(self, name, rank, value):
        self.seen.append(name)
        if name == "put":
            self.win.put(value[1], rank, value[0])
        elif name == "sync":
            assert self.win.sync(rank) == value
        elif name == "device_sync":
            shards, flushed = value
            assert self.win.sync_shards_from_device(
                rank, [(jnp.asarray(c), jnp.asarray(s), off)
                       for c, s, off in shards], blocking=True) == flushed
        elif name == "kill":
            self.comm.mark_dead(rank)
        elif name == "rebuild":
            assert self.comm.rebuild_rank(rank) == value

    def close(self):
        self.win.free()
        self.comm.close()


@pytest.mark.parametrize("transport", ["inproc", "mp"])
def test_replicated_shards_match_reference(tmp_path, chip_smoke, transport):
    """Phase 8a's routine at the small size (a real kill under mp), beside
    the same puts, device syncs, death and rebuild through the JAX
    package: equal flushed and rebuilt bytes, and byte-identical primary
    and replica files."""
    cfg = chip_smoke.smoke_config(1, **SMALL)
    shapes = {k: s.shape for k, s in param_specs(cfg).items()}
    size = max(chip_smoke.shard_layout(g, shapes)["bytes"]
               for g in chip_smoke.shard_groups(shapes))
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    twin = _RefTwin(tmp_path / "ref", size)
    comm = tcore.Communicator(4, transport=transport)
    try:
        out = chip_smoke.rep_shards(cfg, comm, device=torch.device("cpu"),
                                    directory=tmp_path / "port",
                                    on_step=twin, log=lambda *_: None)
    finally:
        comm.close()
        twin.close()
    assert twin.seen.count("device_sync") == 9 and "rebuild" in twin.seen
    ref = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert ref == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(ref) == 8
    for name in ref:
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "ref" / name).read_bytes(), name
    steps = out["steps"]
    assert [s["step"] for s in steps] == [
        "change 1", "changes 1 and 2, rank 2 dead", "clean"]
    assert all(r["flushed_bytes"] == 0 for r in steps[2]["ranks"])
    assert out["rebuild_bytes"] > 0


def test_replicated_phase_at_smoke_widths(tmp_path, chip_smoke):
    """Phase 8's routine at the small size on the CPU: 8a under inproc and
    mp with byte-identical files, 8b's DHT through a SIGKILL, 8c's restore
    with the saving rank dead (all checked inside, exact)."""
    cfg = chip_smoke.smoke_config(1, **SMALL)
    shards7b = {kind: {"ranks": [{"sync_ms": 1.0}] * 3}
                for kind in ("inproc", "mp")}
    out = chip_smoke.replicated_phase(
        cfg, torch.device("cpu"), shards7b, tmp_path / "rep",
        dht=dict(chip_smoke.REP_DHT, lv_entries=128, keys=200, more=50),
        log=lambda *_: None)
    a = out["8a"]
    assert a["files_identical"] == sorted(
        [f"shards.bin.{r}" for r in range(4)]
        + [f"shards.bin.rep1.{r}" for r in range(4)])
    assert a["mp"]["respawn_s"] > 0 and a["inproc"]["respawn_s"] is None
    victim = [r for r in a["mp"]["steps"][1]["ranks"] if r["rank"] == 2][0]
    assert not victim["dead_before"] and victim["dead_after"]
    assert "2:wsync" in victim["messages"] and "3:wsync" in victim["messages"]
    b = out["8b"]
    assert b["lost_synced_keys"] == 0 and b["keys"] == 250
    c = out["8c"]
    assert c["restore"]["step"] == 2 and len(c["saves"]) == 2
    assert 0 < c["saves"][1]["bytes"] < c["saves"][0]["bytes"]
    assert not (tmp_path / "rep").exists()


@pytest.mark.parametrize("transport", ["inproc", "mp"])
def test_replicated_failover_launcher(tmp_path, transport):
    """``python -m repro_torch.launch.replicated_failover`` under both
    transports (a real SIGKILL under mp) passes its own checks."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TRANSPORT=transport, REPRO_NRANKS="4",
               REPRO_MP_TIMEOUT="60")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.replicated_failover",
         "--dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    kill = "SIGKILL" if transport == "mp" else "simulated"
    assert f"kill={kill}" in res.stdout and "0 synced keys lost" in res.stdout
    assert res.stdout.rstrip().endswith("done")


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


# phase 9's routine at the smoke configs: SERVE's shape of traffic, cut
SMOKE_TRAFFIC = dict(batch=2, prompt=13, max_len=32, save_at=5,
                     factor="0.5", steps=12, gate_prompt=11)


@pytest.mark.parametrize("sub", ["9a", "9b", "9c", "9d"])
def test_new_config_phase_at_smoke_widths(tmp_path, chip_smoke, sub):
    """``chip_smoke.new_config_phase`` (phase 9: gemma-7b, qwen2-72b,
    deepseek-v2-236b, llama4-maverick) on the CPU at the smoke configs:
    generate, then the steps again (9c, 9d: through a saved and reopened
    session) with the same tokens and the same final cache, the bf16
    consistency reading (held at 0.02 for 9a), and the float32 gate at
    1e-4 where the entry has one (9c's with the capacity raised: no
    assignment dropped); the MoE configs' routing line."""
    spec = chip_smoke.PHASE9[sub]
    out = chip_smoke.new_config_phase(sub, "cpu", directory=tmp_path / "w",
                                      traffic=SMOKE_TRAFFIC, smoke=True,
                                      log=lambda *a: None)
    assert out["tokens"].shape == (2, 12)
    assert ("session_flushed_bytes" in out) == spec["session"]
    assert np.isfinite(out["consistency_rel_err"])
    cfg = chip_smoke.phase9_config(sub, smoke=True)
    assert ("routing" in out) == bool(cfg.n_experts)
    if cfg.n_experts:
        n_moe = sum(r * p.count("moe") for r, p in cfg.groups())
        assert out["routing"]["of"] == 2 * n_moe
    if spec["f32"] is not None:
        assert out["float32_rel_err"] < chip_smoke.F32_LIMIT
    if sub == "9c":
        assert out["float32_routing"]["dropped_prefill_S1"] == 0
    assert not any(out["comparator_launches"].values())


def test_time_attention_scan_stops_at_the_card_check():
    """``scripts/time_attention_scan.py`` imports what it times (the
    float32 rule from ``repro_torch.convert``) and, without a card, stops
    at ``chip_smoke``'s card check: no ImportError first."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    r = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "time_attention_scan.py"),
         "--src", str(ROOT / "src"), "--rounds", "1"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "ImportError" not in r.stderr, r.stderr[-2000:]
    assert "nvidia-smi not found" in r.stderr, r.stderr[-2000:]


def test_kernel_resources_reads_ptxas_and_sass(monkeypatch, tmp_path):
    """``scripts/kernel_resources.py``: ptxas's registers, stack and spills
    per kernel, and SASS without addresses, encodings or the kernel's own
    name, so two builds of the same code hash alike."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import kernel_resources as kr
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    ptxas = (
        "ptxas info    : Compiling entry function '_Z1aILi1EEvv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1aILi1EEvv\n"
        "    24 bytes stack frame, 20 bytes spill stores, 20 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n")
    assert kr.ptxas_report(ptxas) == {
        "_Z1aILi1EEvv": {"stack": 24, "spill": 20, "registers": 255},
        "_Z1bv": {"stack": 0, "spill": 0, "registers": 96}}

    def sass(name, addr):
        return (f"\t\tFunction : {name}\n"
                f"        /*{addr:04x}*/                   MOV R1, "
                "c[0x0][0x28] ;                    /* 0x00000a0000017a02 */\n"
                "                                                   "
                "                          /* 0x000fe40000000f00 */\n"
                f"        /*{addr + 16:04x}*/                   BRA "
                f"`({name}) ;  /* 0xfffffffc00fc7947 */\n")

    text = sass("_Z1aILi1EEvv", 0) + sass("_Z1aILi2EEvv", 0x10)

    class Done:
        stdout = text
    monkeypatch.setattr(kr.subprocess, "run", lambda *a, **kw: Done)
    monkeypatch.setattr(kr, "tool", lambda name: name)
    got = kr.sass_by_kernel(tmp_path / "x.cubin")
    assert got["_Z1aILi1EEvv"] == ["MOV R1, c[0x0][0x28] ;",
                                   "BRA `(<self>) ;"]
    assert got["_Z1aILi1EEvv"] == got["_Z1aILi2EEvv"]
