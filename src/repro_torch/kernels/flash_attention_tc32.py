"""Attention on the card in float32: the ``flash_attention_tc32`` CUDA kernel.

The counterpart of the JAX package's ``flash_attention_tpu`` for float32
inputs (``csrc/flash_attention_tc32.cu``): the same GQA forward as
:mod:`.flash_attention_tc` (causal, sliding-window or full masks,
``t_actual``, an f32 online softmax with finite -1e30 masking, tiles outside
the mask skipped, strides read in place, any head dimensions up to
:data:`D_MAX`, the value's unlike the query's), with Q.K^T and P.V on the
tensor cores as float32-accurate products: each operand split into TF32
hi + lo, three TF32 products each, which the float32 limit of 2e-5 needs.  It serves every attention layer's
float32 prefill (the float32 gates); bfloat16 inputs go to
:mod:`.flash_attention_tc`.  :mod:`.flash_attention` (the CUDA cores) is
the earlier design, kept as a comparator.  Its plain PyTorch version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention_tc import count_launch, out_like

__all__ = ["D_MAX", "flash_attention_tc32_cuda", "launches"]

#: kernel launches made by :func:`flash_attention_tc32_cuda` (a run that
#: must show it went through the kernel sets this to 0 before and reads it
#: after)
launches = 0

#: the largest head dimension the kernel takes
D_MAX = 256

_SIGNATURES = {
    "flash_attention_tc32_launch": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 22
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
}

_GRID_YZ = 65535  # largest grid y and z: heads and batch


def flash_attention_tc32_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool,
                              window: int | None, scale: float,
                              t_actual: int) -> torch.Tensor:
    """q: (B,H,S,d), k: (B,K,T,d), v: (B,K,T,dv) float32 CUDA tensors,
    the last dimension contiguous, any other strides, d and dv up to
    :data:`D_MAX`.  Returns (B,H,S,dv) float32, laid out as q
    (:func:`~.flash_attention_tc.out_like`).  The caller (:func:`repro_torch.kernels.ops.flash_attention`) has checked
    shapes, ``window`` and ``t_actual``.  Launches on the current stream
    and does not synchronise."""
    global launches
    B, H, S, d = q.shape
    K, T, dv = k.shape[1], k.shape[2], v.shape[3]
    if not ((q.is_cuda or q.is_meta) and q.device == k.device == v.device):
        raise ValueError("flash_attention_tc32_cuda takes q, k, v on one "
                         f"CUDA device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise ValueError("the float32 tensor-core kernel takes float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if max(d, dv) > D_MAX:
        raise ValueError(f"head dimensions {d}, {dv}: more than {D_MAX}, "
                         "which the kernel does not take")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the kernel needs the head dimension contiguous")
    if B > _GRID_YZ or H > _GRID_YZ:
        raise ValueError(f"batch {B} or heads {H} exceed one CUDA grid")
    out = out_like(q, dv)
    if out.stride(-1) != 1:
        raise ValueError("the output's head dimension must be contiguous")
    if out.numel() == 0:
        return out
    if q.is_meta:  # the dry-run: the same checks and buffers, no launch
        count_launch("flash_attention_tc32", q, k, v, causal=causal,
                     window=window, t_actual=t_actual)
        return out
    lib = _build.library("flash_attention_tc32", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_tc32_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, S, T, d, dv, H // K,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            int(causal), 0 if window is None else window, t_actual,
            scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_tc32: CUDA error {err} at "
                           "launch")
    launches += 1
    return out
