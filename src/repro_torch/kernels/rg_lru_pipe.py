"""The RG-LRU recurrence on the card: the ``rg_lru_pipe`` CUDA kernel.

The counterpart of the JAX package's ``rg_lru_tpu``
(``csrc/rg_lru_pipe.cu``): ``h_t = a_t * h_{t-1} + gx_t`` from h = 0 over
(B,S,W), float32 or bfloat16 inputs upcast, y float32.  It runs the
recurrence of every RecurrentGemma ``rglru`` layer's prefill.  One thread
walks one channel, as in :mod:`.rg_lru` (the first design, now a
comparator on no path), but the CTA's inputs arrive ahead of the walk
through a ring of shared-memory stages filled by asynchronous copies.  The
kernel reads a and gx through their batch and position strides (16-byte
copies where the rows are aligned, element by element otherwise) and ends
at S, so nothing is padded.  It rounds the product and the sum one at a
time and in order, as its plain PyTorch version
:func:`repro_torch.kernels.ref.rg_lru_ref` does, and matches it bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..perf.op_analysis import record_launch
from . import _build

__all__ = ["launch_checked", "launches", "rg_lru_pipe_cuda", "work"]

#: kernel launches made by :func:`rg_lru_pipe_cuda` (a run that must show it
#: went through the kernel sets this to 0 before and reads it after)
launches = 0


# the C entry point: a, gx, y, then B, S, W, six strides, bf16, stream
_SIGNATURE = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 10
              + [ctypes.c_void_p], ctypes.c_int)

_GRID_Y = 65535  # largest grid y: batch


def work(B: int, S: int, W: int, *, itemsize: int) -> tuple[int, int]:
    """(FLOP, bytes) of one launch: a product and a sum an element, a and
    gx (``itemsize`` bytes an element) read and y (float32) written once.
    The bounds of ``chip_smoke.py`` and the dry-run's counts both read
    this."""
    return 2 * B * S * W, B * S * W * (2 * itemsize + 4)


def launch_checked(name: str, a: torch.Tensor,
                   gx: torch.Tensor) -> torch.Tensor:
    """Check a and gx as the RG-LRU kernels take them, allocate y and launch
    ``csrc/<name>.cu``'s ``<name>_launch`` on the current stream; returns y.
    Shared by :func:`rg_lru_pipe_cuda` and the comparator
    :func:`repro_torch.kernels.rg_lru.rg_lru_cuda`, whose C entry points
    take the same arguments; each counts its own launches."""
    B, S, W = a.shape
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes float32 or bfloat16, got {a.dtype}")
    if a.stride(-1) != 1 or gx.stride(-1) != 1:
        raise ValueError("the kernel needs the last dimension of a and gx "
                         "contiguous")
    if not ((a.is_cuda or a.is_meta) and a.device == gx.device):
        raise ValueError(f"{name}_cuda takes a and gx on one CUDA device, got "
                         f"{a.device}, {gx.device}")
    if B > _GRID_Y:
        raise ValueError(f"batch {B} exceeds one CUDA grid")
    y = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    if y.numel() == 0:
        return y
    if a.is_meta:  # the dry-run: the same checks and buffers, no launch
        record_launch(name, *work(B, S, W, itemsize=a.element_size()))
        return y
    entry = f"{name}_launch"
    lib = _build.library(name, {entry: _SIGNATURE})
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            a.data_ptr(), gx.data_ptr(), y.data_ptr(), B, S, W,
            *a.stride()[:2], *gx.stride()[:2], *y.stride()[:2],
            int(a.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return y


def rg_lru_pipe_cuda(a: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """a, gx: (B,S,W) CUDA tensors on one device, of one dtype (float32 or
    bfloat16), the last dimension contiguous, any other strides.  Returns y
    (B,S,W) float32, contiguous.  The caller
    (:func:`repro_torch.kernels.ops.rg_lru_scan`) has checked the shapes.
    Launches on the current stream and does not synchronise."""
    global launches
    y = launch_checked("rg_lru_pipe", a, gx)
    if y.numel() and y.is_cuda:
        launches += 1
    return y
