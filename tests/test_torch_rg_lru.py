"""The port's RG-LRU recurrence against the JAX package's, on the same numpy
inputs.

On the CPU, ``ops.rg_lru_scan`` runs its plain version (``ref.rg_lru_ref``,
sequential, float32); the CUDA kernel is held to that bit for bit on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 1d).  Here both
are held to the reference's oracle (``repro.kernels.ref.rg_lru_ref``) and to
its Pallas kernel in interpret mode (which pads S to a block with a = 1,
gx = 0) over the sweep of ``tests/test_kernels.py``, at its tolerance
(1e-5), and in Griffin's published range of a, where the state carries
across the whole sequence.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import tree_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rg_lru import rg_lru_cuda

SWEEP = [(1, 64, 16, 32), (2, 70, 32, 32), (1, 256, 8, 64)]
TOL = 1e-5


def sweep_inputs(B, S, W, dtype="float32", seed=0):
    """a = sigmoid(normal * 0.4) and gx = normal * 0.4 (the sweep's
    distributions) as numpy arrays in ``dtype`` (bf16 as ml_dtypes)."""
    rng = np.random.default_rng(seed)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, W)) * 0.4))
    gx = rng.standard_normal((B, S, W)) * 0.4
    return a.astype(np.float32).astype(npdt), gx.astype(np.float32).astype(npdt)


def published_inputs(B, S, W, seed=0):
    """a = u^r with u ~ U[0.9, 0.999] per channel (Griffin's range) and r ~
    U(0, 1); gx = sqrt(1 - a^2) * normal."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.9, 0.999, W) ** rng.uniform(0, 1, (B, S, W))
    gx = np.sqrt(1 - a * a) * rng.standard_normal((B, S, W))
    return a.astype(np.float32), gx.astype(np.float32)


def port(*arrays):
    return list(tree_from_numpy(dict(enumerate(arrays)), device="cpu").values())


@pytest.mark.parametrize("B,S,W,block", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rg_lru_matches_reference_sweep(B, S, W, block, dtype):
    """``ref.rg_lru_ref`` and ``ops.rg_lru_scan`` (CPU tensors) against the
    reference's oracle and its Pallas kernel in interpret mode (S = 70 is
    ragged against the block of 32)."""
    arrays = sweep_inputs(B, S, W, dtype)
    j = [jnp.asarray(x) for x in arrays]
    want_ref = np.asarray(jref.rg_lru_ref(*j))
    want_kernel = np.asarray(jops.rg_lru_scan(*j, block=block,
                                              impl="interpret"))
    t = port(*arrays)
    got_ops = ops.rg_lru_scan(*t)
    assert got_ops.dtype == torch.float32 and got_ops.shape == (B, S, W)
    for got in (ref.rg_lru_ref(*t), got_ops):
        for want in (want_ref, want_kernel):
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_rg_lru_published_range_matches_reference():
    """a in Griffin's range over 64 positions: the state carries through,
    and both packages agree at 1e-5."""
    a, gx = published_inputs(2, 64, 24)
    want = np.asarray(jref.rg_lru_ref(jnp.asarray(a), jnp.asarray(gx)))
    got = ops.rg_lru_scan(*port(a, gx)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the carried state matters: restarting from 0 at position 32 moves y
    restart = ref.rg_lru_ref(*port(a[:, 32:], gx[:, 32:])).numpy()
    assert np.abs(restart - want[:, 32:]).max() > 100 * TOL


def test_rg_lru_ref_rounds_as_two_operations():
    """The plain version rounds the product and then the sum, each in
    float32 (what the CUDA kernel's __fmul_rn / __fadd_rn do): equal bit
    for bit to that loop in numpy."""
    a, gx = published_inputs(2, 40, 16, seed=3)
    h = np.zeros((2, 16), np.float32)
    want = np.empty_like(a)
    for t in range(a.shape[1]):
        h = (a[:, t] * h).astype(np.float32) + gx[:, t]
        want[:, t] = h
    got = ref.rg_lru_ref(*port(a, gx)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_rg_lru_reads_strided_views():
    """a and gx as views (a column slice of wider storage; (S,B,W) storage
    seen as (B,S,W)): the same bits as contiguous copies."""
    a, gx = published_inputs(3, 21, 40, seed=4)
    ta, tg = port(a, gx)
    wide = torch.cat([ta, ta], dim=-1)[..., 40:]
    sbw = tg.transpose(0, 1).contiguous().transpose(0, 1)
    assert not wide.is_contiguous() and not sbw.is_contiguous()
    assert torch.equal(ops.rg_lru_scan(wide, sbw),
                       ops.rg_lru_scan(ta.contiguous(), tg.contiguous()))


def test_rg_lru_scan_checks_its_arguments():
    a = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="one \\(B,S,W\\) shape"):
        ops.rg_lru_scan(a, torch.zeros(1, 4, 9))
    with pytest.raises(ValueError, match="one \\(B,S,W\\) shape"):
        ops.rg_lru_scan(a[0], a[0])
    with pytest.raises(ValueError, match="floating dtype"):
        ops.rg_lru_scan(a, a.to(torch.bfloat16))
    with pytest.raises(ValueError, match="floating dtype"):
        ops.rg_lru_scan(a.long(), a.long())
    empty = ops.rg_lru_scan(torch.zeros(2, 0, 3), torch.zeros(2, 0, 3))
    assert empty.shape == (2, 0, 3) and empty.dtype == torch.float32


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches or raises; it never falls back."""
    a = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rg_lru_cuda(a, a)
