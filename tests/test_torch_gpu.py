"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips.  This file imports
neither JAX nor ml_dtypes (the card's machine has neither), so it runs
there as

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Inputs are numpy arrays from a seed (bfloat16 as uint16 bit patterns).
Flags, ``count`` and ``packed[:count]`` must be bit-identical, for
aligned and unaligned (offset by one element) views, and for the window's
packed route end to end.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Communicator, Window
from repro_torch.kernels import dirty_diff, ops, pack_diff, ref

PAGE = 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(dtype: str, n: int, block_elems: int, pattern: str, seed: int):
    rng = np.random.default_rng(seed)
    if dtype == "bfloat16":
        bits = rng.integers(0, 1 << 15, size=n, dtype=np.uint16)
        snap = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    elif dtype == "float32":
        snap = torch.from_numpy((rng.standard_normal(n) * 4).astype(np.float32))
    else:
        snap = torch.from_numpy(rng.integers(-100, 100, size=n, dtype=dtype))
    cur = snap.clone()
    nblocks = -(-n // block_elems)
    dirty = {"sparse": sorted({0, nblocks // 2, nblocks - 1}),
             "all_dirty": list(range(nblocks)), "all_clean": []}[pattern]
    idx = torch.tensor([min(b * block_elems + b % block_elems, n - 1)
                        for b in dirty], dtype=torch.long)
    if len(idx):
        cur[idx] += 1
    return cur, snap


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int32"])
@pytest.mark.parametrize("block_elems,n", [(1024, 1024 * 64), (1000, 63_123),
                                           (37, 37 * 301)])
@pytest.mark.parametrize("pattern", ["sparse", "all_clean", "all_dirty"])
def test_cuda_kernels_match_plain_versions(cuda, dtype, block_elems, n,
                                           pattern):
    cur, snap = _pair(dtype, n, block_elems, pattern, n + block_elems)
    c, s = cur.to(cuda), snap.to(cuda)
    for cc, ss in ((c, s), (c[1:], s[1:])):  # aligned, then unaligned
        c2 = ops.padded_rows(cc, block_elems)
        s2 = ops.padded_rows(ss, block_elems)
        flags = ops.dirty_blocks(cc, ss, block_elems=block_elems)
        assert torch.equal(flags, ref.dirty_diff_ref(c2, s2))
        f, p, k = ops.dirty_pack(cc, ss, block_elems=block_elems)
        rf, rp, rk = ref.diff_pack_ref(c2, s2)
        torch.cuda.synchronize()
        assert torch.equal(f, rf) and torch.equal(k, rk)
        rows = int(rk[0])
        assert torch.equal(p[:rows].reshape(-1).view(torch.uint8),
                           rp[:rows].reshape(-1).view(torch.uint8))


@pytest.mark.gpu
def test_window_packed_route_on_the_card(cuda, tmp_path):
    """CUDA tensors through ``sync_shards_from_device``: the kernels launch,
    one bitmap and one payload transfer, the file holds the new bytes."""
    win = Window.allocate(Communicator(1), 32 * PAGE, info={
        "alloc_type": "storage",
        "storage_alloc_filename": str(tmp_path / "w.bin")})
    snap = torch.arange(16 * PAGE // 4, dtype=torch.float32)
    win.put(snap.numpy(), 0, 0)
    win.sync(0)
    cur = snap.clone()
    cur[[5, 9 * PAGE // 4 + 3, 15 * PAGE // 4]] += 1.0
    d0, p0 = dirty_diff.launches, pack_diff.launches
    n = win.sync_from_device(0, cur.to(cuda), snap.to(cuda), blocking=True)
    assert n == 3 * PAGE
    assert dirty_diff.launches > d0 and pack_diff.launches > p0
    st = win.device_sync_stats()
    assert st["payload_transfers"] == st["bitmap_transfers"] == 1
    assert st["span_transfers"] == 0
    disk = np.fromfile(tmp_path / "w.bin", np.float32)
    assert (disk[:cur.numel()] == cur.numpy()).all()
    win.free()
