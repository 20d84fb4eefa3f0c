"""The port's flash attention against the JAX package's, on the CPU.

``repro_torch.kernels.ops.flash_attention`` runs its plain version for CPU
tensors; it is held to the JAX ``ops.flash_attention`` with
``impl='interpret'`` (the Pallas kernel interpreted on the CPU) and to
``ref.flash_attention_ref``, over the sweep of ``tests/test_kernels.py``
plus recurrentgemma-2b's head_dim 256 with 10 query heads over one kv
head: 2e-5 in float32 and 2e-2 in bfloat16; and with a value head dimension
unlike the query's (MLA's d 192, dv 128, and small odd pairs) against the
reference's ``blockwise_attention``.  Inputs are numpy arrays from a
seed; bf16 inputs cross as the same bits.  The CUDA kernel itself runs only
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 1b).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import blockwise_attention
from repro_torch.convert import to_host_f32, tree_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.attention import blockwise_attention as tblockwise
from repro_torch.models.attention import full_attention, prefill_attention

SHAPES = [
    (1, 2, 2, 64, 64, 32),
    (2, 4, 2, 96, 96, 16),     # GQA 2:1
    (1, 4, 1, 40, 72, 32),     # MQA, ragged sizes
    (2, 2, 2, 33, 65, 64),
    (1, 10, 1, 80, 80, 256),   # recurrentgemma-2b: MQA, d 256; window binds
]
MASKS = [(True, None), (False, None), (True, 24)]
# causal assumes aligned q/kv ends: the reference skips causal S != T
SWEEP = [(shape, mask) for shape in SHAPES for mask in MASKS
         if not (mask[0] and shape[3] != shape[4])]


def _mk(shape, seed, dtype, scale=0.4):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale)
    return a.astype(np.float32).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)


def _t(a):
    return tree_from_numpy({"a": a}, device="cpu")["a"]


def _f32(x):
    return to_host_f32(x) if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("shape,mask", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep_matches_reference(shape, mask, dtype):
    B, H, K, S, T, d = shape
    causal, window = mask
    q, k, v = (_mk((B, H, S, d), 0, dtype), _mk((B, K, T, d), 1, dtype),
               _mk((B, K, T, d), 2, dtype))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, S, d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kern = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                q_block=32, kv_block=32, impl="interpret")
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (kern, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_t_actual_masks_trailing_keys():
    """Keys at or past t_actual are masked, as in the TPU kernel's padded
    call: the same as attending to the first t_actual keys only."""
    q, k, v = (_t(_mk((1, 2, 8, 16), 3, "float32")),
               _t(_mk((1, 2, 40, 16), 4, "float32")),
               _t(_mk((1, 2, 40, 16), 5, "float32")))
    got = ops.flash_attention(q, k, v, causal=False, t_actual=29)
    want = ops.flash_attention(q, k[:, :, :29], v[:, :, :29], causal=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)


def test_flash_matches_model_attention():
    """Kernel layout (B,H,S,d) == model layout (B,S,H,d): the port's
    prefill attention against the reference's blockwise path
    (tests/test_kernels.py::test_flash_matches_model_attention)."""
    B, H, K, S, d = 2, 4, 2, 64, 32
    q, k, v = (_mk((B, S, H, d), 11, "float32"), _mk((B, S, K, d), 12, "float32"),
               _mk((B, S, K, d), 13, "float32"))
    want = blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, q_block=32, kv_block=32)
    got = prefill_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    oracle = full_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("bad,match", [
    (dict(k=(1, 3, 8, 16)), "divide"),            # 4 heads, 3 kv heads
    (dict(q=(1, 4, 8, 8)), "pair"),               # head dims differ
    (dict(window=0), "window"),
    (dict(t_actual=0), "t_actual"),
    (dict(t_actual=9), "t_actual"),
])
def test_flash_attention_rejects_bad_input(bad, match):
    shapes = {"q": (1, 4, 8, 16), "k": (1, 2, 8, 16)}
    shapes.update({n: bad[n] for n in ("q", "k") if n in bad})
    q = torch.zeros(shapes["q"])
    k = torch.zeros(shapes["k"])
    kw = {n: bad[n] for n in ("window", "t_actual") if n in bad}
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, k, **kw)


def test_cuda_wrapper_refuses_cpu_tensors_and_large_heads():
    """The kernel wrapper launches or raises; it never falls back."""
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q, causal=True, window=None, scale=1.0,
                                t_actual=8)
    assert fa.D_MAX == 256  # recurrentgemma-2b's head_dim


# -- a value head dimension unlike the query's (MLA: d 192, dv 128) -----------

DV_PAIRS = [(192, 128), (16, 8), (24, 40)]
DV_MASKS = [(True, None, None), (True, 7, None), (False, None, 21)]


@pytest.mark.parametrize("d,dv", DV_PAIRS)
@pytest.mark.parametrize("causal,window,t_actual", DV_MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_value_dim_matches_reference(d, dv, causal, window,
                                                     t_actual, dtype):
    """q, k (d) and v (dv): the plain version against the reference's
    ``blockwise_attention`` (which takes a value head dimension of its own;
    keys past ``t_actual`` left out of its inputs) and the port's, causal,
    windowed and with ``t_actual``: 2e-5 in float32, 2e-2 in bf16
    (tests/test_kernels.py's limits)."""
    B, H, K, S = 2, 4, 2, 37
    T = S if t_actual is None else t_actual
    q, k, v = (_mk((B, S, H, d), 20, dtype), _mk((B, S, K, d), 21, dtype),
               _mk((B, S, K, dv), 22, dtype))
    scale = (d + 3) ** -0.5  # the caller's scale, as MLA passes its own
    got = ops.flash_attention(
        _t(q).transpose(1, 2), _t(k).transpose(1, 2), _t(v).transpose(1, 2),
        causal=causal, window=window, scale=scale, t_actual=t_actual)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (B, H, S, dv)
    want = blockwise_attention(jnp.asarray(q), jnp.asarray(k[:, :T]),
                               jnp.asarray(v[:, :T]), causal=causal,
                               window=window, scale=scale, q_block=16,
                               kv_block=16)
    port = tblockwise(_t(q), _t(k[:, :T]), _t(v[:, :T]), causal=causal,
                      window=window, scale=scale, q_block=16, kv_block=16)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for ref_out in (want, port):
        np.testing.assert_allclose(_f32(got.transpose(1, 2)), _f32(ref_out),
                                   atol=tol, rtol=tol)


def test_prefill_attention_value_dim_in_model_layout():
    """MLA's prefill shape in the model layout, (B,S,H,d) keys and
    (B,S,H,dv) values read through the transposes: the port's
    ``prefill_attention`` against ``full_attention``."""
    B, H, S, d, dv = 1, 4, 33, 192, 128
    q, k = _mk((B, S, H, d), 30, "float32"), _mk((B, S, H, d), 31, "float32")
    kv = _mk((B, S, H, 128 + dv), 32, "float32")
    v = _t(kv)[..., 128:]  # a strided view, as MLA's up-projection gives it
    got = prefill_attention(_t(q), _t(k), v, causal=True, scale=0.07)
    assert got.shape == (B, S, H, dv)
    want = full_attention(_t(q), _t(k), v, causal=True, scale=0.07)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("bad,match", [
    (dict(v=(1, 2, 9, 8)), "k \\(B,K,T,d\\) and v"),  # keys and values differ
    (dict(v=(1, 2, 8, 257)), "head dimensions"),
    (dict(q=(1, 4, 8, 300), k=(1, 2, 8, 300)), "head dimensions"),
])
def test_flash_attention_rejects_bad_value_dims(bad, match):
    shapes = {"q": (1, 4, 8, 16), "k": (1, 2, 8, 16), "v": (1, 2, 8, 16)}
    shapes.update(bad)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(*(torch.zeros(shapes[n]) for n in "qkv"))


def test_cuda_wrappers_take_value_dim_and_comparator_refuses_it():
    """The tensor-core wrappers shape their output by v (laid out as q);
    the CUDA-core comparator, on no path, refuses dv != d with a clear
    error before it could launch."""
    from repro_torch.kernels.flash_attention_tc import out_like
    q = torch.zeros(2, 7, 4, 192).transpose(1, 2)  # (B,H,S,d) over (B,S,H,d)
    out = out_like(q, 128)
    assert out.shape == (2, 4, 7, 128)
    assert out.transpose(1, 2).is_contiguous()
    assert torch.empty_like(q).stride() == out_like(q, 192).stride()
    v = torch.zeros(2, 4, 7, 128)
    with pytest.raises(ValueError, match="one head dimension"):
        fa.flash_attention_cuda(q, q, v, causal=True, window=None, scale=1.0,
                                t_actual=7)
