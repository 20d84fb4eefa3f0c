"""The Mamba-2 SSD scan on the card for bfloat16 inputs: ``ssd_scan_tc``.

The counterpart of the JAX package's ``ssd_scan_tpu`` for bfloat16 x, Bm
and C (``csrc/ssd_scan_tc.cu``): the same scan as :mod:`.ssd_scan`, with
the chunks in parallel (chunk-local states, a short sequential pass over
the chunks, then each chunk's output) and the products on the tensor cores,
every float32 operand split into two bf16 parts so the result stays within
float32 rounding.  It runs the scan of every Mamba-2 layer's bf16 prefill
and returns the final state too; float32 inputs go to
:mod:`.ssd_scan_tc32`.
The wrapper allocates the chunk states' scratch.  Its plain PyTorch version
is :func:`repro_torch.kernels.ref.ssd_scan_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from ..perf.op_analysis import record_launch
from . import _build

__all__ = ["CHUNK", "N_MAX", "P_MAX", "count_launch", "launches",
           "ssd_scan_tc_cuda", "work"]

#: launches of the kernel (its three passes) made by
#: :func:`ssd_scan_tc_cuda` (a run that must show it went through the
#: kernel sets this to 0 before and reads it after)
launches = 0

#: the largest state size and head dimension the kernel takes
N_MAX = 128
P_MAX = 64

#: positions per chunk (the kernel's constant L)
CHUNK = 64

_SIGNATURES = {
    "ssd_scan_tc_launch": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 20
        + [ctypes.c_void_p], ctypes.c_int),
}

_GRID_YZ = 65535  # largest grid y and z: heads and batch


def work(B: int, H: int, S: int, P: int, N: int, *, itemsize: int,
         bc_heads: int = 1, chunk: int = CHUNK) -> tuple[int, int]:
    """(FLOP, bytes) of one launch, the least work of the function: the
    chunked form at the kernel's chunk, scores only for i >= j (l(l+1)/2
    of a chunk of l), C.h and the state update; x, Bm and C
    (``itemsize`` bytes an element; Bm and C hold ``bc_heads`` distinct
    head rows: 1 where one group is broadcast over the heads), dt and A
    (float32) read once, y and the final state (float32) written once.
    The bounds of ``chip_smoke.py`` and the dry-run's counts both read
    this; the float32 kernel does the same work."""
    pairs = sum(min(chunk, S - s0) * (min(chunk, S - s0) + 1) // 2
                for s0 in range(0, S, chunk))
    return (2 * B * H * (pairs * (N + P) + 2 * S * N * P),
            itemsize * (B * S * H * P + 2 * B * S * N * bc_heads)
            + 4 * (B * H * S + H) + 4 * (B * H * S * P + B * H * N * P))


def count_launch(name: str, x, Bm) -> None:
    """A launch on meta tensors: counted (:func:`work`), nothing run."""
    B, H, S, P = x.shape
    record_launch(name, *work(B, H, S, P, Bm.shape[-1],
                              itemsize=x.element_size(),
                              bc_heads=1 if Bm.stride(1) == 0 else H))


def ssd_scan_tc_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, C: torch.Tensor):
    """x: (B,H,S,P); dt: (B,H,S); A: (H,); Bm/C: (B,H,S,N), CUDA tensors on
    one device.  x, Bm and C are bfloat16 with their last dimension
    contiguous, any other strides (0 included; rows in aligned 16-byte
    chunks load by cp.async, others element by element); dt and A are
    float32; N <= :data:`N_MAX`, P <= :data:`P_MAX`.  Returns
    ``(y (B,H,S,P) float32, h (B,H,N,P) float32)``; y is dense in x's order of dimensions.  The caller
    (:func:`repro_torch.kernels.ops.ssd_scan`) has checked the shapes.
    Launches on the current stream and does not synchronise."""
    global launches
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    if not ((x.is_cuda or x.is_meta) and x.device == dt.device == A.device
            == Bm.device == C.device):
        raise ValueError("ssd_scan_tc_cuda takes its tensors on one CUDA "
                         f"device, got {x.device}, {dt.device}, {A.device}, "
                         f"{Bm.device}, {C.device}")
    if not x.dtype == Bm.dtype == C.dtype == torch.bfloat16:
        raise ValueError("the tensor-core kernel takes bfloat16 x, Bm, C, "
                         f"got {x.dtype}, {Bm.dtype}, {C.dtype}")
    if not (dt.dtype == A.dtype == torch.float32):
        raise ValueError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if N > N_MAX or P > P_MAX:
        raise ValueError(f"state size {N} or head dimension {P} exceeds "
                         f"{N_MAX} / {P_MAX}, which the kernel takes")
    if any(t.stride(-1) != 1 for t in (x, Bm, C)):
        raise ValueError("the kernel needs the last dimension of x, Bm and C "
                         "contiguous")
    if B > _GRID_YZ or H > _GRID_YZ:
        raise ValueError(f"batch {B} or heads {H} exceed one CUDA grid")
    y = torch.empty_like(x, dtype=torch.float32)  # dense, x's dimension order
    if y.numel() == 0:
        return y, torch.zeros((B, H, N, P), dtype=torch.float32,
                              device=x.device)
    nc = -(-S // CHUNK)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    states = torch.empty((B, H, nc, N, P), dtype=torch.float32,
                         device=x.device)
    hin = torch.empty((B, H, nc, N_MAX * P_MAX), dtype=torch.float32,
                      device=x.device)
    decay = torch.empty((B, H, nc), dtype=torch.float32, device=x.device)
    if x.is_meta:  # the dry-run: the same checks and buffers, no launch
        count_launch("ssd_scan_tc", x, Bm)
        return y, h
    A = A.contiguous()
    lib = _build.library("ssd_scan_tc", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_tc_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), y.data_ptr(), h.data_ptr(), states.data_ptr(),
            hin.data_ptr(), decay.data_ptr(), B, H, S, N, P,
            *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *C.stride()[:3],
            *y.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_tc: CUDA error {err} at launch")
    launches += 1
    return y, h
