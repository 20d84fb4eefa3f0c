"""The port's SSD scan against the JAX package's, on the same numpy inputs.

On the CPU, ``ops.ssd_scan`` runs its plain version (``ref.ssd_scan_ref``,
sequential, float32); the CUDA kernel is held to that on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 1c).  Here both are
held to the reference's oracle (``repro.kernels.ref.ssd_scan_ref``) and to
its Pallas kernel in interpret mode over the sweep of
``tests/test_kernels.py``, at its tolerances (1e-4 float32, 3e-2 bf16,
relative to the largest |y|), and the port's plain-torch ``ssd_chunked``
is held to the reference's.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.convert import to_host_f32, tree_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.models import ssm

SWEEP = [(1, 2, 64, 16, 8, 32), (2, 3, 50, 8, 16, 16), (1, 1, 128, 32, 4, 64)]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def scan_inputs(B, H, S, P, N, dtype, seed=0):
    """x, dt, A, Bm, C as numpy arrays (x, Bm, C in ``dtype``; bf16 as
    ml_dtypes), with the sweep's distributions."""
    rng = np.random.default_rng(seed)
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32

    def mk(shape, scale=0.4):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = mk((B, H, S, P)).astype(npdt)
    dt = np.log1p(np.exp(mk((B, H, S)))).astype(np.float32)  # softplus
    A = -np.exp(mk((H,), 0.3 * 0.4)).astype(np.float32)
    Bm = mk((B, H, S, N)).astype(npdt)
    C = mk((B, H, S, N)).astype(npdt)
    return x, dt, A, Bm, C


def port(*arrays):
    return list(tree_from_numpy(dict(enumerate(arrays)), device="cpu").values())


def rel_to_max(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(1e-3, np.abs(want).max()))


@pytest.mark.parametrize("B,H,S,P,N,chunk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_reference_sweep(B, H, S, P, N, chunk, dtype):
    """``ref.ssd_scan_ref`` and ``ops.ssd_scan`` (CPU tensors) against the
    reference's oracle and its Pallas kernel in interpret mode."""
    arrays = scan_inputs(B, H, S, P, N, dtype)
    j = [jnp.asarray(a) for a in arrays]
    want_ref = jref.ssd_scan_ref(*j)
    want_kernel = jops.ssd_scan(*j, chunk=chunk, impl="interpret")
    t = port(*arrays)
    got_ref = ref.ssd_scan_ref(*t)
    got_ops = ops.ssd_scan(*t)
    assert got_ops.dtype == torch.float32 and got_ops.shape == (B, H, S, P)
    for got in (got_ref, got_ops):
        for want in (want_ref, want_kernel):
            assert rel_to_max(got.numpy(), want) < TOL[dtype]


def test_ssd_scan_reads_model_layout_and_head_broadcast():
    """x as a view of (B,S,H,P) storage and Bm, C as one group broadcast
    over the heads (head stride 0): the same result as contiguous copies,
    and y comes back in x's layout."""
    B, H, S, P, N = 2, 4, 37, 8, 16
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, S, 2, N)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32))
    A = -torch.from_numpy(rng.uniform(1, 4, H).astype(np.float32))
    x = xs.transpose(1, 2)
    Bm = g[:, :, 0, None].expand(B, S, H, N).transpose(1, 2)
    C = g[:, :, 1, None].expand(B, S, H, N).transpose(1, 2)
    assert Bm.stride(1) == 0
    y, h = ops.ssd_scan(x, dt.transpose(1, 2), A, Bm, C, return_state=True)
    y2, h2 = ops.ssd_scan(x.contiguous(), dt.transpose(1, 2).contiguous(), A,
                          Bm.contiguous(), C.contiguous(), return_state=True)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(h, h2, rtol=0, atol=0)
    assert h.shape == (B, H, N, P)


@pytest.mark.parametrize("S,chunk", [(64, 16), (50, 16), (37, 8)])
def test_ssd_scan_final_state_matches_ssd_chunked(S, chunk):
    """The state returned with ``return_state`` against the reference's
    ``ssd_chunked`` h_last (the model's decode carry), at 1e-4."""
    B, H, P, N = 2, 3, 8, 16
    x, dt, A, Bm, C = scan_inputs(B, H, S, P, N, "float32", seed=S)
    to_bshp = (0, 2, 1, 3)
    _, want = jssm.ssd_chunked(
        jnp.asarray(x.transpose(to_bshp)), jnp.asarray(dt.transpose(0, 2, 1)),
        jnp.asarray(A), jnp.asarray(Bm.transpose(to_bshp)),
        jnp.asarray(C.transpose(to_bshp)), chunk=chunk)
    _, h = ops.ssd_scan(*port(x, dt, A, Bm, C), return_state=True)
    assert rel_to_max(h.numpy(), want) < 1e-4


@pytest.mark.parametrize("S,chunk", [(16, 16), (37, 16), (50, 8), (64, 32),
                                     (5, 16)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_ssd_chunked_matches_reference(S, chunk, dtype, tol):
    """The port's plain-torch chunked form, (B,S,H,P) layout, with and
    without an initial state, cast for cast: y and h_last."""
    B, H, P, N = 2, 3, 8, 16
    x, dt, A, Bm, C = scan_inputs(B, H, S, P, N, dtype, seed=S + chunk)
    to_bshp = (0, 2, 1, 3)
    args = (x.transpose(to_bshp), dt.transpose(0, 2, 1), A,
            Bm.transpose(to_bshp), C.transpose(to_bshp))
    h0 = np.random.default_rng(1).standard_normal((B, H, N, P)).astype(
        np.float32)
    for init in (None, h0):
        jy, jh = jssm.ssd_chunked(*[jnp.asarray(a) for a in args], chunk=chunk,
                                  h0=None if init is None else jnp.asarray(init))
        ty, th = ssm.ssd_chunked(*port(*args), chunk=chunk,
                                 h0=None if init is None else port(init)[0])
        assert ty.shape == (B, S, H, P) and ty.dtype == torch.float32
        assert rel_to_max(to_host_f32(ty), jy) < tol
        assert rel_to_max(to_host_f32(th), jh) < tol


def test_ssd_scan_checks_its_arguments():
    x, dt, A, Bm, C = port(*scan_inputs(1, 2, 8, 4, 4, "float32"))
    with pytest.raises(ValueError, match="do not pair"):
        ops.ssd_scan(x, dt[:, :, :5], A, Bm, C)
    with pytest.raises(ValueError, match="share a dtype"):
        ops.ssd_scan(x, dt, A, Bm.to(torch.bfloat16), C)
    with pytest.raises(ValueError, match="one CUDA device"):
        ssd_scan_cuda(x, dt, A, Bm, C)  # the kernel never takes CPU tensors


def test_ssd_scan_empty_sequence():
    x, dt, A, Bm, C = port(*scan_inputs(1, 2, 0, 4, 4, "float32"))
    y, h = ops.ssd_scan(x, dt, A, Bm, C, return_state=True)
    assert y.shape == (1, 2, 0, 4) and torch.count_nonzero(h) == 0
