"""The RG-LRU recurrence's CUDA kernel, ``rg_lru_pipe``, as far as the CPU
can see it: dispatch, the wrapper's checks, and the smoke script's build
and launch bookkeeping.

The kernel runs only on the card, where ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phase 1d hold it to its plain version bit for bit; the
plain version is held to the JAX package in ``tests/test_torch_rg_lru.py``.
"""

import dataclasses
import functools
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import (_build, flash_attention_tc,
                                 flash_attention_tc32, ops, rg_lru,
                                 rg_lru_pipe)

ROOT = Path(__file__).resolve().parents[1]


@functools.cache
def _chip_smoke():
    """``chip_smoke.py`` (the repo root's script) as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_names_the_pipelined_kernel(dtype):
    assert ops.cuda_kernel("rg_lru", dtype) is rg_lru_pipe.rg_lru_pipe_cuda
    assert ops.kernel_module("rg_lru", dtype) is rg_lru_pipe
    assert isinstance(rg_lru_pipe.launches, int)
    assert ops.kernel_module("rg_lru", dtype) is not rg_lru  # a comparator


def test_dispatch_refuses_other_dtypes():
    with pytest.raises(ValueError, match="no CUDA kernel of rg_lru"):
        ops.cuda_kernel("rg_lru", torch.float16)


@pytest.mark.parametrize("wrapper", [rg_lru_pipe.rg_lru_pipe_cuda,
                                     rg_lru.rg_lru_cuda])
def test_wrappers_refuse_what_the_kernels_do_not_take(wrapper):
    """CPU tensors, float16 and a strided last dimension raise before
    anything is built or counted: never a silent fallback."""
    counts = (rg_lru_pipe.launches, rg_lru.launches)
    a = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(a, a)
    half = a.to(torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        wrapper(half, half)
    cols = a.transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(cols, cols)
    assert (rg_lru_pipe.launches, rg_lru.launches) == counts
    assert "rg_lru_pipe" not in _build._libs and "rg_lru" not in _build._libs


def test_plain_version_on_cpu_launches_nothing():
    counts = (rg_lru_pipe.launches, rg_lru.launches)
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.full((2, 7, 3), 0.5, dtype=dtype)
        y = ops.rg_lru_scan(a, a)
        assert y.dtype == torch.float32 and y.shape == (2, 7, 3)
    assert (rg_lru_pipe.launches, rg_lru.launches) == counts


def test_chip_smoke_builds_every_source():
    """``KERNELS`` and the build list name every ``csrc/*.cu`` once, and
    each row names the TPU kernel it replaces by the line of its def."""
    cs = _chip_smoke()
    sources = sorted(p.stem for p in _build.SOURCES.glob("*.cu"))
    assert sorted(cs.BUILD) == sources
    for name, row in cs.KERNELS.items():
        assert (ROOT / row["source"]).is_file(), name
        path, line = row["replaces"].rsplit(":", 1)
        text = (ROOT / path).read_text().splitlines()[int(line) - 1]
        assert re.match(r"def \w+_tpu\(", text), (name, text)
    assert cs.KERNELS["rg_lru_pipe"]["replaces"] == \
        cs.KERNELS["rg_lru"]["replaces"]


@pytest.mark.parametrize("dtype,attn", [("bfloat16", flash_attention_tc),
                                        ("float32", flash_attention_tc32)])
def test_prefill_counts_read_the_pipelined_kernel(dtype, attn):
    """Phase 5 holds recurrentgemma-2b's prefill to 18 launches of the
    recurrence's kernel (one a rglru block) and 8 of attention."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), dtype=dtype)
    assert _chip_smoke().prefill_kernels(cfg) == {attn: 8, rg_lru_pipe: 18}


def test_chip_smoke_profile_names_every_kernel():
    """``OWN_KERNELS`` picks out every device function of ``csrc`` (as the
    profiler names it, in an anonymous namespace) and none of PyTorch's."""
    cs = _chip_smoke()
    names = set()
    for src in _build.SOURCES.glob("*.cu*"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
            src.read_text()))
    assert len(names) >= 10
    for name in names:
        assert cs.OWN_KERNELS.search(f"void (anonymous namespace)::{name}<")
    for other in ("void (anonymous namespace)::elementwise_kernel_with_index<",
                  "void at::native::(anonymous namespace)::CatArrayBatchedCopy_",
                  "nvjet_tst_192x192_64x3_1x2_h_bz_coopB_NNN"):
        assert not cs.OWN_KERNELS.search(other)
