"""The RG-LRU recurrence on the card: the ``rg_lru`` CUDA kernel.

The counterpart of the JAX package's ``rg_lru_tpu`` (``csrc/rg_lru.cu``):
``h_t = a_t * h_{t-1} + gx_t`` from h = 0 over (B,S,W), float32 or bfloat16
inputs upcast, y float32.  It runs the recurrence of every RecurrentGemma
``rglru`` layer's prefill.  The kernel reads a and gx through their batch
and position strides and ends its loop at S, so nothing is padded (the
reference pads S to a block with a = 1, gx = 0).  It rounds the product and
the sum one at a time, as its plain PyTorch version
:func:`repro_torch.kernels.ref.rg_lru_ref` does, and matches it bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["launches", "rg_lru_cuda"]

#: kernel launches made by :func:`rg_lru_cuda` (a run that must show it went
#: through the kernel sets this to 0 before and reads it after)
launches = 0

_SIGNATURES = {
    "rg_lru_launch": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 10 + [ctypes.c_void_p],
        ctypes.c_int),
}

_GRID_Y = 65535  # largest grid y: batch


def rg_lru_cuda(a: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """a, gx: (B,S,W) CUDA tensors on one device, of one dtype (float32 or
    bfloat16), the last dimension contiguous, any other strides.  Returns y
    (B,S,W) float32, contiguous.  The caller
    (:func:`repro_torch.kernels.ops.rg_lru_scan`) has checked the shapes.
    Launches on the current stream and does not synchronise."""
    global launches
    B, S, W = a.shape
    if not (a.is_cuda and a.device == gx.device):
        raise ValueError("rg_lru_cuda takes a and gx on one CUDA device, got "
                         f"{a.device}, {gx.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bfloat16, got {a.dtype}")
    if a.stride(-1) != 1 or gx.stride(-1) != 1:
        raise ValueError("the kernel needs the last dimension of a and gx "
                         "contiguous")
    if B > _GRID_Y:
        raise ValueError(f"batch {B} exceeds one CUDA grid")
    y = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    if y.numel() == 0:
        return y
    lib = _build.library("rg_lru", _SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rg_lru_launch(
            a.data_ptr(), gx.data_ptr(), y.data_ptr(), B, S, W,
            *a.stride()[:2], *gx.stride()[:2], *y.stride()[:2],
            int(a.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rg_lru: CUDA error {err} at launch")
    launches += 1
    return y
