"""The port's out-of-core AdamW against the JAX package's.

Both optimizers get the same numpy parameters and gradients (made from a
seed); the port gets them as CPU tensors.  After ``initialize``, three
``update`` steps and a ``sync_masters_from_device``, the window files must
match: the Adam moments byte for byte, the master weights within the
tolerance below.  The tolerance is for the learning rate alone: the schedule
is float32 in both packages, but PyTorch's float32 ``cos`` and XLA's may
round the last bit differently (1 ulp of a number near 1), and ``1 + cos``
cancels near the end of the schedule, so the two learning rates agree to
``LR_TOL * cfg.lr`` in absolute terms, not to a fixed number of ulps of the
(possibly tiny) rate.  One step moves a master weight by ``lr * upd`` with
``|upd| <= UPD_MAX`` here, so after ``n`` steps the masters agree within
``n * LR_TOL * lr * UPD_MAX`` plus 4 float32 ulps of rounding.  Everything
else in the update is the same numpy arithmetic.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.train.offload_opt import OutOfCoreAdamW as JAdamW
from repro.train.optimizer import AdamWConfig as JConfig
from repro.train.optimizer import cosine_schedule as j_schedule
import repro_torch.core as tcore
from repro_torch.train import AdamWConfig, OutOfCoreAdamW, cosine_schedule

PAGE = 4096
LR_TOL = 4 * 2.0 ** -23  # learning-rate tolerance, relative to cfg.lr
UPD_MAX = 10.0           # bound on |Adam update| for these inputs


def _close(a: np.ndarray, b: np.ndarray, lr: float, steps: int) -> bool:
    """Masters within the module docstring's tolerance."""
    atol = steps * LR_TOL * lr * UPD_MAX
    return bool(np.all(np.abs(a - b) <= atol + 2.0 ** -21 * np.abs(b)))



@pytest.mark.parametrize("cfg", [
    dict(lr=1e-2, warmup_steps=3, total_steps=1000),
    dict(),
    dict(lr=1e-2, warmup_steps=0, total_steps=10),
    dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.0),
], ids=["warm3", "default", "nowarm", "to_zero"])
def test_cosine_schedule_float32_matches_reference(cfg):
    jc, tc = JConfig(**cfg), AdamWConfig(**cfg)
    for step in range(0, min(tc.total_steps + 5, 400)):
        got = cosine_schedule(tc, step, device="cpu")
        assert got.dtype == torch.float32
        want = np.float32(j_schedule(jc, step))
        assert abs(got.item() - float(want)) <= LR_TOL * tc.lr, step


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 40), "norm/b": (2048,), "emb": (3, 1500)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    grads[1]["norm/b"][:] = 0.0  # a provable no-op block walk
    return shapes, params, grads


def _slot_bytes(path, slot) -> np.ndarray:
    raw = np.fromfile(path, np.uint8)
    return raw[slot.offset: slot.offset + slot.nbytes]


def test_initialize_update_sync_matches_reference(tmp_path):
    shapes, params, grads = _trees()
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.01)
    spec = {k: (s, np.float32) for k, s in shapes.items()}
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jo = JAdamW(jcore.Communicator(1), spec, str(tmp_path / "j"),
                JConfig(**cfg), block_bytes=1024)
    to = OutOfCoreAdamW(tcore.Communicator(1), spec, str(tmp_path / "t"),
                        AdamWConfig(**cfg), block_bytes=1024)
    jo.initialize(params)
    to.initialize({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    assert jo.state.sync() == to.state.sync()
    for g in grads:
        jout = jo.update(g)
        tout = to.update({k: torch.from_numpy(v.copy()) for k, v in g.items()})
        assert sorted(jout) == sorted(tout)
        for k in jout:
            assert tout[k].dtype == np.float32 and tout[k].shape == shapes[k]
            assert _close(tout[k], jout[k], cfg["lr"], to.step), k
    assert to.blocks_skipped == jo.blocks_skipped
    assert to.sync(touched_only=True) == jo.sync(touched_only=True)

    # device-resident masters: a sparse change on two tensors
    jm = jo.masters()
    tm = {k: torch.from_numpy(v.copy()) for k, v in to.masters().items()}
    jnew = {k: v.copy() for k, v in jm.items()}
    tnew = {k: v.clone() for k, v in tm.items()}
    for tree in (jnew, tnew):
        tree["w"].reshape(-1)[[3, 1500]] += 1.0
        tree["emb"].reshape(-1)[-1] += 1.0
    jf = jo.sync_masters_from_device(jnew, jm, impl="ref")
    tf = to.sync_masters_from_device(tnew, tm)
    assert jf == tf == 3 * PAGE
    st = to.state.win.device_sync_stats()
    assert st["payload_transfers"] == st["bitmap_transfers"] == 1
    jpath, tpath = tmp_path / "j" / "optstate.bin", tmp_path / "t" / "optstate.bin"
    assert jpath.stat().st_size == tpath.stat().st_size
    for name, slot in to.state.slots.items():
        assert dataclasses.astuple(jo.state.slots[name]) == \
            dataclasses.astuple(slot)
        a, b = _slot_bytes(tpath, slot), _slot_bytes(jpath, slot)
        if name.startswith("master/"):
            assert _close(a.view(np.float32), b.view(np.float32), cfg["lr"],
                          to.step), name
        else:
            assert (a == b).all(), name  # moments: bit-exact
    jo.free()
    to.free()


def test_offload_opt_sync_masters_from_device(tmp_path):
    """Mirror of the reference test: only the changed pages of the changed
    tensors flush, names absent from ``masters`` are skipped, and a dtype
    that does not match the window layout is refused."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                      clip_norm=0.0, weight_decay=0.0)
    shapes = {"w": ((2 * PAGE // 4,), np.float32),
              "b": ((PAGE // 4,), np.float32)}
    params = {k: torch.arange(int(np.prod(s[0])), dtype=torch.float32)
              for k, s in shapes.items()}
    oo = OutOfCoreAdamW(tcore.Communicator(1), shapes, str(tmp_path), cfg)
    oo.initialize(params)
    oo.state.sync()
    old = {k: torch.from_numpy(v.copy()) for k, v in oo.masters().items()}
    new = {k: v.clone() for k, v in old.items()}
    new["w"][(PAGE // 4) + 3] += 1.0
    assert oo.sync_masters_from_device(new, old) == PAGE
    assert (oo.state.get("master/w") == new["w"].numpy()).all()
    assert (oo.state.get("master/b") == old["b"].numpy()).all()
    assert oo.state.win.dirty_bytes(0) == 0
    assert oo.sync_masters_from_device({}, {}) == 0
    with pytest.raises(ValueError, match="window layout"):
        oo.sync_masters_from_device({"w": new["w"].double()},
                                    {"w": old["w"].double()})
    with pytest.raises(ValueError, match="window layout"):
        oo.sync_masters_from_device({"w": new["w"].bfloat16()},
                                    {"w": old["w"].bfloat16()})
    oo.free()


def test_offload_opt_selective_write_behind(tmp_path):
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                      clip_norm=0.0, weight_decay=0.01)
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((64, 16)).astype(np.float32),
              "norm/b": np.zeros(2048, np.float32)}
    oo = OutOfCoreAdamW(tcore.Communicator(1),
                        {k: (v.shape, v.dtype) for k, v in params.items()},
                        str(tmp_path), cfg, block_bytes=1024)
    oo.initialize({k: torch.from_numpy(v) for k, v in params.items()})
    oo.state.sync()
    grads = {"w": torch.from_numpy(
                 rng.standard_normal((64, 16)).astype(np.float32)),
             "norm/b": torch.zeros(2048, dtype=torch.bfloat16)}
    out = oo.update(grads)
    assert set(out) == {"norm/b", "w"}
    assert (out["norm/b"] == 0).all()
    assert oo.blocks_skipped == 8
    flushed = oo.sync(touched_only=True)
    assert 0 < flushed <= 3 * 2 * PAGE
    assert oo.state.win.dirty_bytes(0) == 0
    out = oo.update({"w": grads["w"]})
    assert set(out) == {"w"}
    assert oo.sync(touched_only=True) > 0
    assert oo.sync(touched_only=True) == 0
    oo.free()


def test_offload_opt_touched_mask_survives_flush_failure(tmp_path):
    """A failed touched-only flush restores the mask (replay, never skip)."""
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                      clip_norm=0.0, weight_decay=0.01)
    oo = OutOfCoreAdamW(tcore.Communicator(1), {"w": ((256, 16), np.float32)},
                        str(tmp_path), cfg, block_bytes=1024)
    oo.initialize({"w": torch.ones(256, 16)})
    oo.state.sync()
    oo.update({"w": torch.ones(256, 16)})
    backing = oo.state.win.segments[0].backing
    orig = backing.file.pwrite

    def dying(offset, data):
        raise OSError("disk died mid-flush")

    backing.file.pwrite = dying
    with pytest.raises(OSError):
        oo.sync(touched_only=True)
    backing.file.pwrite = orig
    assert oo.sync(touched_only=True) > 0
    assert oo.state.win.dirty_bytes(0) == 0
    oo.free()
