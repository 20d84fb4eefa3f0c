"""The reference's four remaining examples as the port's entry points.

``repro_torch.launch.quickstart``, ``out_of_core_dht``,
``mapreduce_wordcount`` and ``long_context_serve`` run as subprocesses
(the DHT and MapReduce under ``--transport inproc`` and ``mp``, the
serving one with ``--device cpu``) beside ``examples/*.py`` on the JAX
package.  What must match: every printed line but the timings (rates and
seconds) and, for MapReduce, the checkpointed KiB total, which depends on
how the background syncs coalesce in either package; the window files
byte for byte (the examples write under ``TMPDIR``, the entry points
under ``--dir``); the DHT's lookups, the word counts, and the resumed
tokens for the example's own parameters and prompt.
"""

import re
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMED = re.compile(r"\d+(\.\d+)?(?=/s|s\b)")  # "32338/s", "in 0.02s"


def _run(args, tmp, **env):
    """A Python command from the repo root, ``TMPDIR`` at ``tmp``; its
    standard output's lines."""
    r = subprocess.run(
        [sys.executable, *args], cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu", "TMPDIR": str(tmp), **env},
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.splitlines()


def _example(name, tmp):
    """``examples/<name>.py`` (its files go to a directory under ``tmp``):
    (lines, that directory)."""
    tmp.mkdir()
    lines = _run([f"examples/{name}.py"], tmp)
    made = [p for p in tmp.iterdir() if p.is_dir()]
    assert len(made) == 1
    return lines, made[0]


def _entry(name, tmp, *args):
    out = tmp / "files"
    out.mkdir(parents=True)
    return _run(["-m", f"repro_torch.launch.{name}", "--dir", str(out),
                 *args], tmp), out


def _same_files(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names and names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def _untimed(lines):
    return [TIMED.sub("#", line) for line in lines]


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    """Each example, run once on the JAX package: {name: (lines, dir)}."""
    return {name: _example(name, tmp_path_factory.mktemp(name) / "ref")
            for name in ("quickstart", "out_of_core_dht",
                         "mapreduce_wordcount")}


def test_quickstart_matches_example(examples, tmp_path):
    want, ref_dir = examples["quickstart"]
    got, port_dir = _entry("quickstart", tmp_path)
    assert got[:-1] == want[:-1]
    assert got[-1] == f"quickstart done; files under {port_dir}"
    assert "dht[7] = 49" in got and "rank1 sees: 44" in got
    _same_files(ref_dir, port_dir)


@pytest.mark.parametrize("transport", ["inproc", "mp"])
def test_out_of_core_dht_matches_example(examples, tmp_path, transport):
    """The table's per-rank segment split, the insert count, the flushed
    MiB and the probe's hits as the example prints them; the table's four
    window files byte for byte."""
    want, ref_dir = examples["out_of_core_dht"]
    got, port_dir = _entry("out_of_core_dht", tmp_path, "--transport",
                           transport)
    assert got[0] == f"transport={transport} ranks=4"
    assert _untimed(got[1:]) == _untimed(want[1:])
    assert "inserted 13107 keys" in got[2]
    _same_files(ref_dir, port_dir)


def test_out_of_core_dht_lookups_match_reference(tmp_path):
    """The entry point's ``run`` in process: the first 100 inserted keys'
    counts after the sync, as the reference's table gives them for the
    example's traffic."""
    import repro.core as jcore
    from repro_torch.core import Communicator
    from repro_torch.launch import out_of_core_dht as ooc
    (tmp_path / "port").mkdir()
    comm = Communicator(4)
    try:
        got = ooc.run(comm, str(tmp_path / "port"), log=lambda *a: None)
    finally:
        comm.close()
    jcomm = jcore.Communicator(4)
    dht = jcore.DistributedHashTable(jcomm, ooc.LV, heap_factor=4, info={
        "alloc_type": "storage",
        "storage_alloc_filename": str(tmp_path / "ref.bin"),
        "storage_alloc_factor": "auto"}, memory_budget=ooc.BUDGET)
    keys = np.random.default_rng(0).integers(1, 1 << 48, got["inserted"])
    for k in keys:
        dht.insert(int(k), 1, op="sum")
    assert dht.sync() == got["flushed_bytes"]
    want = [dht.lookup(int(k)) for k in keys[:100]]
    dht.free()
    jcomm.close()
    assert got["found"] == want and all(v >= 1 for v in want)


@pytest.mark.parametrize("transport", ["inproc", "mp"])
def test_mapreduce_wordcount_matches_example(examples, tmp_path, transport):
    """The crash point, the checkpointed KiB before it, 'the''s count and
    the number of syncs as the example prints them; the reduce table's
    and the progress windows' files byte for byte."""
    want, ref_dir = examples["mapreduce_wordcount"]
    got, port_dir = _entry("mapreduce_wordcount", tmp_path, "--transport",
                           transport)
    assert got[0] == f"transport={transport} ranks=4"
    total = re.compile(r"\d+ KiB total")
    assert [total.sub("# KiB total", line) for line in got[1:]] == \
        [total.sub("# KiB total", line) for line in want[1:]]
    assert "wordcount ok: 'the' -> 840" in got
    _same_files(ref_dir, port_dir)


def test_mapreduce_word_counts_match_reference(tmp_path):
    """The entry point's ``run`` in process: every word's count equals the
    reference's ``wordcount_reduce`` over the example's tasks."""
    from repro.core.mapreduce import wordcount_map as j_map
    from repro_torch.core import Communicator
    from repro_torch.launch import mapreduce_wordcount as mrw
    comm = Communicator(4)
    try:
        got = mrw.run(comm, str(tmp_path), log=lambda *a: None)
    finally:
        comm.close()
    want: dict[int, int] = {}
    for t in mrw.tasks():
        for k, v in j_map(t).items():
            want[k] = want.get(k, 0) + v
    assert got["ok"] and got["counts"] == want
    assert got["crash_after"] == 2 and got["ckpt_count"] == 16


def test_long_context_serve_matches_example(tmp_path):
    """The example's run (recurrentgemma-2b smoke, its ``jax.random``
    parameters and prompt) against the entry point's ``run`` on the same
    parameters and prompt: the same printed lines, so the same resumed
    tokens; then the entry point itself with ``--device cpu``."""
    from repro.configs import get_config as j_get_config
    from repro.models import init_params as j_init_params
    from repro.models import param_specs as j_param_specs
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import long_context_serve as lcs
    want = _run(["examples/long_context_serve.py"], tmp_path)
    jcfg = j_get_config(lcs.ARCH, smoke=True)
    params = {k: np.asarray(v) for k, v in j_init_params(
        j_param_specs(jcfg), jax.random.PRNGKey(0)).items()}
    toks = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (lcs.B, lcs.PROMPT), 0,
        jcfg.vocab).astype("int32"))
    cfg = get_config(lcs.ARCH, smoke=True)
    lines = []
    with tempfile.TemporaryDirectory(dir=tmp_path) as d:
        out = lcs.run(cfg, params_from_numpy(cfg, params, device="cpu"), toks,
                      d, device="cpu",
                      log=lambda *a: lines.append(" ".join(map(str, a))))
    assert out["exact"] and out["resumed_at"] == lcs.PROMPT + lcs.SAVE_AT - 1
    assert lines == want[:-1]
    assert want[2] == ("resumed generation is bit-exact: "
                       f"{out['resumed'][0].tolist()}")
    got = _run(["-m", "repro_torch.launch.long_context_serve", "--device",
                "cpu"], tmp_path)
    assert got[1] == "resumed at position 13" and got[-1] == "done"
    assert got[2].startswith("resumed generation is bit-exact: [")


def test_entry_points_take_transport_and_device():
    """``--transport`` where the example runs under both transports,
    ``--device`` (default the card) for the serving one."""
    from repro_torch.launch import long_context_serve, mapreduce_wordcount
    from repro_torch.launch import out_of_core_dht
    import torch
    for mod in (out_of_core_dht, mapreduce_wordcount):
        with pytest.raises(SystemExit):
            mod.main(["--transport", "tcp"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            long_context_serve.main([])
