"""The RG-LRU recurrence on the card: the ``rg_lru`` CUDA kernel.

The first counterpart of the JAX package's ``rg_lru_tpu``
(``csrc/rg_lru.cu``): ``h_t = a_t * h_{t-1} + gx_t`` from h = 0 over
(B,S,W), float32 or bfloat16 inputs upcast, y float32, one thread a channel
loading its next positions itself.  It is on no path since the recurrence
of every RecurrentGemma ``rglru`` layer's prefill goes to
:mod:`.rg_lru_pipe` (the same arithmetic, its loads streamed through
shared memory); it stays as a comparator that ``chip_smoke.py`` holds to
its plain version and times beside its successor.  The kernel reads a and
gx through their batch and position strides and ends its loop at S, so
nothing is padded (the reference pads S to a block with a = 1, gx = 0).  It
rounds the product and the sum one at a time, as its plain PyTorch version
:func:`repro_torch.kernels.ref.rg_lru_ref` does, and matches it bit for bit.
"""

from __future__ import annotations

import torch

from .rg_lru_pipe import launch_checked

__all__ = ["launches", "rg_lru_cuda"]

#: kernel launches made by :func:`rg_lru_cuda` (a run that must show it went
#: through the kernel sets this to 0 before and reads it after)
launches = 0


def rg_lru_cuda(a: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    """a, gx: (B,S,W) CUDA tensors on one device, of one dtype (float32 or
    bfloat16), the last dimension contiguous, any other strides.  Returns y
    (B,S,W) float32, contiguous.  The caller has checked the shapes.
    Launches on the current stream and does not synchronise."""
    global launches
    y = launch_checked("rg_lru", a, gx)
    if y.numel():
        launches += 1
    return y
