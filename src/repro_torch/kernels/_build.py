"""Build this package's CUDA sources with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own, for ``sm_90a``, into
``build/repro_torch/lib<name>-<hash>.so`` at the root of the checkout; the
hash covers the source and the flags, so an edited source builds anew and an
unchanged one is loaded as it is.  Sources expose a plain C interface (no
PyTorch headers), which keeps a build to seconds.  Nothing is compiled when
a module is imported: the first launch builds what it needs, and
:func:`build` starts several ``nvcc`` processes at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "build", "library",
           "source_path"]

_PKG = Path(__file__).resolve().parents[1]
SOURCES = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> Path:
    return SOURCES / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, dict]:
    """Compile every source in ``names`` that is not built yet, one ``nvcc``
    process per source, all started together.  Returns, per name, the
    seconds its build took (0 when it was already built) and the compiler's
    output (``-Xptxas -v`` register and spill counts).  Raises
    ``RuntimeError`` with the output of the first build that fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    out: dict[str, dict] = {}
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = {"seconds": 0.0, "log": "", "path": str(target)}
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.monotonic())
    failed = None
    for name, (proc, tmp, target, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.monotonic() - t0
        if proc.returncode != 0:
            failed = failed or (name, log)
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        out[name] = {"seconds": seconds, "log": log, "path": str(target)}
    if failed is not None:
        raise RuntimeError(f"nvcc failed for {source_path(failed[0])}:\n"
                           f"{failed[1]}")
    return out


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C entry point to ``(argtypes, restype)``; every
    pointer and the stream are ``ctypes.c_void_p`` (a plain int argument
    would be cut to 32 bits)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (argtypes, restype) in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = restype
            _libs[name] = lib
        return lib
