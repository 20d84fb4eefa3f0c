"""The port's training launcher in its three bootstrap modes, on the CPU.

``python -m repro_torch.launch.train --device cpu --arch internlm2-1.8b
--smoke`` runs single-controller over inproc, mp and tcp, and under
``--spmd`` with two application ranks: every rank draws the same data from
the same seed (``_build_trainer`` makes ``SyntheticLM`` without a rank, as
the JAX package's does), so the SPMD ranks' float32 losses equal the
single-controller run's, bit for bit.  ``launch/spmd_train_resume.py``
(a rank SIGKILLed and respawned, then a whole-job restart) exits 0.  The
``TrainConfig.probe_interval_s`` knob reaches the Trainer's failure
detector, and ``--mesh`` trains at one rank as the single controller does.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "internlm2-1.8b", "--smoke", "--device", "cpu",
        "--steps", "3"]


def _run(module: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_MP_TIMEOUT="60", REPRO_TCP_TIMEOUT="60")
    for k in ("REPRO_TRANSPORT", "REPRO_RANK", "REPRO_NRANKS",
              "REPRO_HOSTS", "REPRO_RENDEZVOUS", "REPRO_SANITIZE"):
        env.pop(k, None)
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)


def _ok(r: subprocess.CompletedProcess) -> str:
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


@pytest.fixture(scope="module")
def single():
    """The single-controller run's (first, last) loss per transport."""
    out = {}
    for kind in ("inproc", "mp", "tcp"):
        text = _ok(_run("repro_torch.launch.train", *ARGS,
                        "--transport", kind))
        m = re.search(r"rank 0/1 done: 3 step\(s\) from step 0, loss "
                      r"(\S+) -> (\S+) \(cpu, transport=(\w+)\)", text)
        assert m, text
        assert m.group(3) == kind
        out[kind] = (float(m.group(1)), float(m.group(2)))
    return out


def test_single_controller_transports_agree(single):
    assert single["inproc"] == single["mp"] == single["tcp"]


def test_spmd_ranks_equal_single_controller(single):
    text = _ok(_run("repro_torch.launch.train", *ARGS, "--spmd",
                    "--nranks", "2", "--probe-interval", "0.2"))
    finals = {int(r): float(loss) for r, loss in re.findall(
        r"rank (\d): 3 step\(s\) from step 0 on cpu, final loss (\S+)",
        text)}
    assert finals == {0: single["inproc"][1], 1: single["inproc"][1]}, text
    assert "spmd done: 2 rank(s), launcher data ops: 0" in text


def test_spmd_train_resume_exits_zero():
    text = _ok(_run("repro_torch.launch.spmd_train_resume", "--device",
                    "cpu"))
    assert "rank 1 resumed from step 2 after SIGKILL" in text
    assert "all 2 ranks resumed exactly at step 6" in text
    assert "spmd_train_resume: PASS" in text


def test_mesh_raises_naming_the_item(single):
    """Named for the refusal ``--mesh`` replaced: one process started as
    ``torch.distributed.run`` starts it (a 1x1 mesh through
    ``REPRO_MESH_OVERRIDE``) trains, losses equal to the single-controller
    run's; rank 0 prints the sharding report (empty at one rank: no
    mapping has an axis of size > 1).  Four ranks:
    tests/test_torch_mesh_train.py."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), REPRO_MESH_OVERRIDE="1x1")
    for k in ("REPRO_TRANSPORT", "REPRO_RANK", "REPRO_NRANKS"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *ARGS, "--mesh"], env=env, capture_output=True,
                       text=True, timeout=300)
    text = _ok(r)
    assert "mesh {'data': 1, 'model': 1} (gloo), rules train; " \
        "sharding_report (mappings left replicated): {}" in text
    m = re.search(r"rank 0/1 done: 3 step\(s\) from step 0, loss "
                  r"(\S+) -> (\S+) \(cpu, transport=ranklocal\)", text)
    assert m, text
    assert (float(m.group(1)), float(m.group(2))) == single["inproc"]


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_trainer_probe_interval_reaches_detector():
    """``TrainConfig.probe_interval_s`` sets the failure detector's probe
    rate-limit (the reference's field, which its launcher's
    ``--probe-interval`` feeds); the default stays one second."""
    from repro_torch.configs import get_config
    from repro_torch.core import Communicator
    from repro_torch.launch.train import _build_trainer
    from repro_torch.train import AdamWConfig, TrainConfig, Trainer

    cfg = get_config("internlm2-1.8b", smoke=True)
    tr = Trainer(cfg, AdamWConfig(), TrainConfig(probe_interval_s=0.2),
                 device="cpu")
    assert tr.detector.interval == 0.2
    assert Trainer(cfg, AdamWConfig(), TrainConfig(),
                   device="cpu").detector.interval == 1.0
    opts = {"arch": "internlm2-1.8b", "smoke": True, "steps": 3, "batch": 2,
            "seq": 16, "microbatches": 1, "lr": 3e-4, "ckpt_dir": None,
            "ckpt_every": 0, "mode": None, "compression": False,
            "probe_interval": 0.3, "device": "cpu"}
    tr, _ = _build_trainer(opts, Communicator(1))
    assert tr.detector.interval == 0.3 and tr.device.type == "cpu"


def test_layers_cuts_the_depth_and_keeps_the_widths():
    """``--layers N`` (``opts["layers"]``) cuts the config to N layers at
    its widths, as chip_smoke.py's phase 9m (b) trains internlm2-1.8b;
    without it the config is whole."""
    from repro_torch.configs import get_config
    from repro_torch.core import Communicator
    from repro_torch.launch.train import _build_trainer

    opts = {"arch": "internlm2-1.8b", "smoke": True, "layers": 1,
            "steps": 1, "batch": 2, "seq": 16, "microbatches": 1,
            "lr": 3e-4, "ckpt_dir": None, "ckpt_every": 0, "mode": "fused",
            "compression": False, "probe_interval": 1.0, "device": "cpu"}
    whole = get_config("internlm2-1.8b", smoke=True)
    assert whole.n_layers > 1
    tr, _ = _build_trainer(opts, Communicator(1))
    assert tr.model_cfg == dataclasses.replace(whole, n_layers=1)
    tr, _ = _build_trainer(dict(opts, layers=None), Communicator(1))
    assert tr.model_cfg == whole
