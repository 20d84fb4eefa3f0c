"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips.  This file imports
neither JAX nor ml_dtypes (the card's machine has neither), so it runs
there as

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Inputs are numpy arrays from a seed (bfloat16 as uint16 bit patterns).
Flags, ``count`` and ``packed[:count]`` must be bit-identical, for
aligned and unaligned (offset by one element) views, and for the window's
packed route end to end.  The attention kernels are held to their plain
version at 2e-5 (float32, ``flash_attention_tc32``) and 2e-2 (bfloat16,
``flash_attention_tc``), over the sweep of ``tests/test_kernels.py`` plus
d = 128 and d = 256, in both layouts (at d = 256 with recurrentgemma-2b's
MQA and a window that binds), and must give the same bits twice; both also
at the prefill shapes with q and k at std 1.5 (``chip_smoke.py`` phase
1b's limits: rtol = atol = 2e-5 float32, rtol 1e-2 and atol 1e-4 bf16),
and at head dimensions that are not multiples of 8 and on views offset by
one element.  The SSD scan kernels are held to their plain version at
1e-4 (float32, ``ssd_scan_tc32``) and 3e-2 (bfloat16, ``ssd_scan_tc``)
relative to the largest |y| over the sweep of ``tests/test_kernels.py``, y
and the final state, and at 1e-4 through the model's strides (x a view of
(B,S,H,P) storage, Bm and C broadcast over heads with a head stride of 0),
at odd P, and at 1e-4 per 256 positions at mamba2-2.7b's prefill shape
(phase 1c's limit), where a scan that drops the carried state fails.  Each
dtype must launch its own kernel, and each kernel raises on what it does
not take.  The earlier CUDA-core float32 kernels (``flash_attention``,
``ssd_scan``), on no path now, are still held to the plain versions as
comparators.  The RG-LRU kernel (``rg_lru_pipe``, both dtypes) must
equal its plain version bit for bit over the sweep of
``tests/test_kernels.py`` (ragged S included), through strided views and a
view one element in (its element-by-element copies), at a ragged shape
that wraps its ring of stages many times (same bits twice), and at
recurrentgemma-2b's prefill shape with a in Griffin's range; the first
RG-LRU kernel (``rg_lru``), on no path now, is held the same way as a
comparator.

The training path runs no kernel of the package; its tests here hold the
``Trainer`` on the card at smoke widths under
``torch.use_deterministic_algorithms`` (whose cuBLAS products need
``CUBLAS_WORKSPACE_CONFIG``, set below before CUDA starts): two identical
fused steps give the same bits, a kill, restore and continue equals the
uninterrupted run bit for bit, and the compression and offload modes run
and lower the loss on a fixed batch.  One test runs here too: the
``Trainer`` raises when CUDA is asked for and absent, and runs with
``device="cpu"``.
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import pytest
import torch

from repro_torch.core import Communicator, Window
from repro_torch.kernels import (dirty_diff, flash_attention,
                                 flash_attention_tc, flash_attention_tc32,
                                 ops, pack_diff, ref, rg_lru, ssd_scan,
                                 ssd_scan_tc, ssd_scan_tc32)
from repro_torch.models.attention import prefill_attention
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.train import AdamWConfig, TrainConfig, Trainer

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


ATTN_SHAPES = [(1, 2, 2, 64, 64, 32), (2, 4, 2, 96, 96, 16),
               (1, 4, 1, 40, 72, 32), (2, 2, 2, 33, 65, 64),
               (1, 4, 2, 130, 130, 128), (1, 4, 2, 130, 130, 256),
               (2, 10, 1, 70, 70, 256)]
ATTN_SWEEP = [(shape, mask) for shape in ATTN_SHAPES
              for mask in [(True, None), (False, None), (True, 24)]
              if not (mask[0] and shape[3] != shape[4])]


def _normal(shape, seed, dtype, device):
    a = np.random.default_rng(seed).standard_normal(shape) * 0.4
    return torch.from_numpy(a.astype(np.float32)).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mask", ATTN_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(cuda, shape, mask,
                                                      dtype):
    B, H, K, S, T, d = shape
    causal, window = mask
    q = _normal((B, H, S, d), 0, dtype, cuda)
    k = _normal((B, K, T, d), 1, dtype, cuda)
    v = _normal((B, K, T, d), 2, dtype, cuda)
    mod = {torch.float32: flash_attention_tc32,
           torch.bfloat16: flash_attention_tc}[dtype]
    n0 = mod.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert mod.launches == n0 + 2
    assert got.dtype == dtype and torch.equal(got, again)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_attention_model_layout_reads_in_place(cuda):
    """(B,S,H,d) tensors go to the kernel as strided views, and the output
    comes back contiguous in that layout."""
    q = _normal((2, 70, 4, 64), 3, torch.bfloat16, cuda)
    k = _normal((2, 70, 2, 64), 4, torch.bfloat16, cuda)
    v = _normal((2, 70, 2, 64), 5, torch.bfloat16, cuda)
    got = prefill_attention(q, k, v, causal=True)
    assert got.is_contiguous()
    want = ref.flash_attention_ref(q.transpose(1, 2).contiguous(),
                                   k.transpose(1, 2).contiguous(),
                                   v.transpose(1, 2).contiguous())
    torch.testing.assert_close(got.float(), want.transpose(1, 2).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 48])
def test_flash_attention_d256_model_layout(cuda, window):
    """recurrentgemma-2b's local attention at a small S: d 256, 10 query
    heads over one kv head, (B,S,H,d) tensors read through their strides,
    with and without a window that binds (S 150 > 48)."""
    q = _normal((2, 150, 10, 256), 6, torch.bfloat16, cuda)
    k = _normal((2, 150, 1, 256), 7, torch.bfloat16, cuda)
    v = _normal((2, 150, 1, 256), 8, torch.bfloat16, cuda)
    got = prefill_attention(q, k, v, causal=True, window=window)
    assert got.is_contiguous()
    want = ref.flash_attention_ref(q.transpose(1, 2).contiguous(),
                                   k.transpose(1, 2).contiguous(),
                                   v.transpose(1, 2).contiguous(),
                                   window=window)
    torch.testing.assert_close(got.float(), want.transpose(1, 2).float(),
                               atol=2e-2, rtol=2e-2)


SSD_SHAPES = [(1, 2, 64, 16, 8), (2, 3, 50, 8, 16), (1, 1, 128, 32, 4),
              (2, 4, 300, 64, 128)]


def _ssd_inputs(B, H, S, P, N, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.4):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(device)
    return (mk(B, H, S, P).to(dtype), torch.nn.functional.softplus(mk(B, H, S)),
            -torch.exp(mk(H, scale=0.12)), mk(B, H, S, N).to(dtype),
            mk(B, H, S, N).to(dtype))


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain_version(cuda, shape, dtype):
    args = _ssd_inputs(*shape, dtype, cuda)
    mod = {torch.float32: ssd_scan_tc32, torch.bfloat16: ssd_scan_tc}[dtype]
    n0 = mod.launches
    y, h = ops.ssd_scan(*args, return_state=True)
    y2, h2 = ops.ssd_scan(*args, return_state=True)
    want, want_h = ref.ssd_scan_ref(*args, return_state=True)
    torch.cuda.synchronize()
    assert mod.launches == n0 + 2
    assert y.dtype == h.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(h, h2)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel(y, want) < tol and _rel(h, want_h) < tol


@pytest.mark.gpu
def test_ssd_scan_model_layout_and_head_broadcast(cuda):
    """x a view of (B,S,H,P) storage, Bm and C one group broadcast over
    the heads, dt a view of (B,S,H), ragged S: read in place, y written in
    x's layout, equal to the plain version on contiguous copies."""
    B, H, S, P, N = 2, 6, 203, 64, 128
    rng = np.random.default_rng(7)
    xbc = torch.from_numpy(rng.standard_normal(
        (B, S, H * P + 2 * N)).astype(np.float32)).to(cuda, torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    bm = xbc[..., H * P:H * P + N, None].transpose(2, 3).expand(
        B, S, H, N).transpose(1, 2)
    c = xbc[..., H * P + N:, None].transpose(2, 3).expand(
        B, S, H, N).transpose(1, 2)
    dt = torch.from_numpy(rng.uniform(1e-3, 1e-1, (B, S, H)).astype(
        np.float32)).to(cuda).transpose(1, 2)
    A = -torch.from_numpy(rng.uniform(1, 16, H).astype(np.float32)).to(cuda)
    assert bm.stride(1) == 0 and x.stride(1) == P
    y, h = ops.ssd_scan(x, dt, A, bm, c, return_state=True)
    assert y.transpose(1, 2).is_contiguous()
    want, want_h = ref.ssd_scan_ref(x.contiguous(), dt.contiguous(), A,
                                    bm.contiguous(), c.contiguous(),
                                    return_state=True)
    torch.cuda.synchronize()
    assert _rel(y, want) < 1e-4 and _rel(h, want_h) < 1e-4


@pytest.mark.gpu
def test_ssd_scan_kernel_limits(cuda):
    assert ops.kernel_module("ssd_scan", torch.float32) is ssd_scan_tc32
    args = list(_ssd_inputs(1, 2, 8, 4, ssd_scan_tc32.N_MAX + 1,
                            torch.float32, cuda))
    with pytest.raises(ValueError, match="exceeds"):
        ops.ssd_scan(*args)
    args = list(_ssd_inputs(1, 2, 8, ssd_scan_tc32.P_MAX + 1, 4,
                            torch.float32, cuda))
    with pytest.raises(ValueError, match="exceeds"):
        ops.ssd_scan(*args)


RG_SHAPES = [(1, 64, 16), (2, 70, 32), (1, 256, 8), (3, 1000, 300)]


def _rg_inputs(B, S, W, dtype, device, seed=0):
    """a = sigmoid(normal * 0.4), gx = normal * 0.4 (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, W)) * 0.4))
    gx = rng.standard_normal((B, S, W)) * 0.4
    return (torch.from_numpy(a.astype(np.float32)).to(device, dtype),
            torch.from_numpy(gx.astype(np.float32)).to(device, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RG_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rg_lru_kernel_matches_plain_version(cuda, shape, dtype):
    a, gx = _rg_inputs(*shape, dtype, cuda)
    kernel = ops.kernel_module("rg_lru", dtype)
    n0 = kernel.launches
    y = ops.rg_lru_scan(a, gx)
    y2 = ops.rg_lru_scan(a, gx)
    want = ref.rg_lru_ref(a, gx)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 2
    assert y.dtype == torch.float32 and y.shape == shape
    assert torch.equal(y, want) and torch.equal(y, y2)


@pytest.mark.gpu
def test_rg_lru_kernel_reads_strided_views(cuda):
    """a a column slice of wider storage, gx (S,B,W) storage seen as
    (B,S,W): the same bits as the plain version on contiguous copies."""
    a, gx = _rg_inputs(2, 77, 96, torch.float32, cuda, seed=1)
    wide = torch.cat([a, a], dim=-1)[..., 96:]
    sbw = gx.transpose(0, 1).contiguous().transpose(0, 1)
    assert not wide.is_contiguous() and not sbw.is_contiguous()
    got = ops.rg_lru_scan(wide, sbw)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.rg_lru_ref(a, gx))


@pytest.mark.gpu
def test_rg_lru_kernel_at_the_prefill_shape(cuda):
    """recurrentgemma-2b's prefill (B 4, S 2000, W 2560) with a = u^r, u in
    Griffin's range [0.9, 0.999]: y bit-identical to the plain version."""
    B, S, W = 4, 2000, 2560
    rng = np.random.default_rng(2)
    a = rng.uniform(0.9, 0.999, W) ** rng.uniform(0, 1, (B, S, W))
    gx = np.sqrt(1 - a * a) * rng.standard_normal((B, S, W))
    a = torch.from_numpy(a.astype(np.float32)).to(cuda)
    gx = torch.from_numpy(gx.astype(np.float32)).to(cuda)
    got = ops.rg_lru_scan(a, gx)
    want = ref.rg_lru_ref(a, gx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rg_lru_kernel_wraps_its_ring(cuda, dtype):
    """Ragged S and W (S 1999, W 2600 = 40 CTAs of 64 channels and one of
    40) that wrap the ring of stages many times: the same bits as the plain
    version, twice, and the comparator does not launch."""
    a, gx = _rg_inputs(3, 1999, 2600, dtype, cuda, seed=3)
    n0, c0 = ops.kernel_module("rg_lru", dtype).launches, rg_lru.launches
    y = ops.rg_lru_scan(a, gx)
    y2 = ops.rg_lru_scan(a, gx)
    want = ref.rg_lru_ref(a, gx)
    torch.cuda.synchronize()
    assert torch.equal(y, want) and torch.equal(y, y2)
    assert ops.kernel_module("rg_lru", dtype).launches == n0 + 2
    assert rg_lru.launches == c0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rg_lru_kernel_unaligned_view(cuda, dtype):
    """Columns 1..W of wider storage: no row is 16-byte aligned, so the
    kernel copies element by element; the same bits as the plain version."""
    a, gx = _rg_inputs(2, 301, 97, dtype, cuda, seed=4)
    got = ops.rg_lru_scan(a[..., 1:], gx[..., 1:])
    want = ref.rg_lru_ref(a[..., 1:], gx[..., 1:])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", RG_SHAPES + [(3, 1999, 2600)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rg_lru_comparator_matches_plain_version(cuda, shape, dtype):
    """The first RG-LRU kernel, on no path, called directly."""
    a, gx = _rg_inputs(*shape, dtype, cuda, seed=5)
    n0 = rg_lru.launches
    y = rg_lru.rg_lru_cuda(a, gx)
    torch.cuda.synchronize()
    assert rg_lru.launches == n0 + 1
    assert torch.equal(y, ref.rg_lru_ref(a, gx))


@pytest.mark.gpu
def test_rg_lru_kernel_limits(cuda):
    a = torch.zeros(1, 4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.rg_lru_scan(a, a)
    b = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rg_lru_scan(b.transpose(1, 2), b.transpose(1, 2))


# the prefill shapes of phase 1b: (B, H, K, S, d, window)
TC_ATTN_MAIN = [(4, 16, 8, 2000, 128, None), (4, 10, 1, 2000, 256, 2048),
                (1, 10, 1, 4096, 256, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,K,S,d,window", TC_ATTN_MAIN)
def test_flash_attention_tc_at_the_prefill_shapes(cuda, B, H, K, S, d,
                                                  window):
    """The tensor-core kernel at phase 1b's main shapes and limits (rtol
    1e-2, atol 1e-4; q and k at std 1.5, model layout), the same bits
    twice; the float32 kernels do not launch."""
    rng = np.random.default_rng(S + d)

    def mk(heads, std):
        a = rng.standard_normal((B, S, heads, d)) * std
        return torch.from_numpy(a.astype(np.float32)).to(
            cuda, torch.bfloat16).transpose(1, 2)
    q, k, v = mk(H, 1.5), mk(K, 1.5), mk(K, 0.4)
    n_tc, n_f32 = flash_attention_tc.launches, flash_attention_tc32.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    again = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_tc.launches == n_tc + 2
    assert flash_attention_tc32.launches == n_f32
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-4)


@pytest.mark.gpu
def test_flash_attention_tc_refuses_what_it_does_not_take(cuda):
    """Head dimensions past D_MAX, other dtypes, and each kernel's other
    dtype (any d up to 256 at any alignment is taken: see
    test_flash_attention_any_head_dim_and_alignment)."""
    for mod in (flash_attention_tc, flash_attention_tc32):
        assert mod.D_MAX == 256
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(1, 2, 8, 264, device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="256"):
            ops.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        flash_attention_tc32.flash_attention_tc32_cuda(
            q, q, q, causal=True, window=None, scale=1.0, t_actual=8)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ops.flash_attention(*(torch.zeros(1, 2, 8, 16, device=cuda,
                                          dtype=torch.float16),) * 3)
    f32 = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention_tc.flash_attention_tc_cuda(
            f32, f32, f32, causal=True, window=None, scale=1.0, t_actual=8)
    with pytest.raises(ValueError, match="float32"):
        flash_attention.flash_attention_cuda(
            q, q, q, causal=True, window=None, scale=1.0, t_actual=8)


def _chunk_rel(y, want, chunk=256):
    return max(float((y[:, :, s:s + chunk] - want[:, :, s:s + chunk]).abs()
                     .max() / want[:, :, s:s + chunk].abs().max())
               for s in range(0, want.shape[2], chunk))


@pytest.mark.gpu
def test_ssd_scan_tc_at_the_prefill_shape(cuda):
    """mamba2-2.7b's prefill layer (B 4, H 80, S 2000, P 64, N 128) as the
    model hands it over, dt and A in Mamba-2's published ranges: y within
    1e-4 per 256 positions and the state within 1e-4 (phase 1c's limit),
    the same bits twice, while a scan that zeroes the carried state every
    256 positions fails that limit."""
    B, H, S, P, N = 4, 80, 2000, 64, 128
    rng = np.random.default_rng(9)
    xbc = torch.from_numpy(rng.standard_normal(
        (B, S, H * P + 2 * N)).astype(np.float32)).to(cuda, torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    bm = xbc[..., H * P:H * P + N, None].transpose(2, 3).expand(
        B, S, H, N).transpose(1, 2)
    c = xbc[..., H * P + N:, None].transpose(2, 3).expand(
        B, S, H, N).transpose(1, 2)
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                             (B, S, H))).astype(
        np.float32)).to(cuda).transpose(1, 2)
    A = -torch.from_numpy(rng.uniform(1, 16, H).astype(np.float32)).to(cuda)
    n_tc, n_f32 = ssd_scan_tc.launches, ssd_scan_tc32.launches
    y, h = ops.ssd_scan(x, dt, A, bm, c, return_state=True)
    y2, h2 = ops.ssd_scan(x, dt, A, bm, c, return_state=True)
    want, want_h = ref.ssd_scan_ref(x, dt, A, bm, c, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan_tc.launches == n_tc + 2
    assert ssd_scan_tc32.launches == n_f32
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert _chunk_rel(y, want) < 1e-4 and _rel(h, want_h) < 1e-4
    zeroed = torch.cat([ref.ssd_scan_ref(
        x[:, :, s:s + 256], dt[:, :, s:s + 256], A, bm[:, :, s:s + 256],
        c[:, :, s:s + 256]) for s in range(0, S, 256)], dim=2)
    assert _chunk_rel(zeroed, want) > 1e-4


@pytest.mark.gpu
def test_ssd_scan_tc_refuses_what_it_does_not_take(cuda):
    """N past N_MAX, P past P_MAX, other dtypes, and each kernel's other
    dtype (an odd P is taken: see test_ssd_scan_odd_head_dim)."""
    for N, P in ((ssd_scan_tc.N_MAX + 8, 16), (16, 66)):
        args = list(_ssd_inputs(1, 2, 8, P, N, torch.bfloat16, cuda))
        with pytest.raises(ValueError, match="exceeds"):
            ops.ssd_scan(*args)
    x, dt, A, bm, c = _ssd_inputs(1, 2, 8, 16, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ops.ssd_scan(x.half(), dt, A, bm.half(), c.half())
    with pytest.raises(ValueError, match="float32"):
        ssd_scan.ssd_scan_cuda(x, dt, A, bm, c)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan_tc32.ssd_scan_tc32_cuda(x, dt, A, bm, c)


@pytest.mark.gpu
def test_ssd_scan_tc_element_loads(cuda):
    """Rows that are not whole aligned 16-byte chunks (N 12, x starting 2
    bytes past an aligned address) load element by element and give the
    plain version's result at 1e-4, over a ragged last chunk (S 203)."""
    B, H, S, P, N = 2, 3, 203, 16, 12
    x, dt, A, bm, c = _ssd_inputs(B, H, S, P + 1, N, torch.bfloat16, cuda)
    x = x[..., 1:]
    assert x.data_ptr() % 16 != 0
    y, h = ssd_scan_tc.ssd_scan_tc_cuda(x, dt, A, bm, c)
    want, want_h = ref.ssd_scan_ref(x, dt, A, bm, c, return_state=True)
    torch.cuda.synchronize()
    assert _rel(y, want) < 1e-4 and _rel(h, want_h) < 1e-4


# -- float32 on the tensor cores, the comparators, and every head dim ---------

@pytest.mark.gpu
@pytest.mark.parametrize("B,H,K,S,d,window", TC_ATTN_MAIN)
def test_flash_attention_tc32_at_the_prefill_shapes(cuda, B, H, K, S, d,
                                                    window):
    """The float32 tensor-core kernel at phase 1b's main shapes and its
    float32 limits (rtol = atol = 2e-5; q and k at std 1.5, model layout),
    the same bits twice; neither the bf16 kernel nor the comparator
    launches."""
    rng = np.random.default_rng(S + d + 1)

    def mk(heads, std):
        a = rng.standard_normal((B, S, heads, d)) * std
        return torch.from_numpy(a.astype(np.float32)).to(cuda).transpose(1, 2)
    q, k, v = mk(H, 1.5), mk(K, 1.5), mk(K, 0.4)
    mods = (flash_attention_tc32, flash_attention_tc, flash_attention)
    before = [m.launches for m in mods]
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    again = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert [m.launches for m in mods] == [before[0] + 2, *before[1:]]
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mask", ATTN_SWEEP)
def test_flash_attention_comparator_matches_plain_version(cuda, shape, mask):
    """The earlier CUDA-core float32 kernel, kept as a comparator, over the
    sweep at 2e-5."""
    B, H, K, S, T, d = shape
    causal, window = mask
    q = _normal((B, H, S, d), 0, torch.float32, cuda)
    k = _normal((B, K, T, d), 1, torch.float32, cuda)
    v = _normal((B, K, T, d), 2, torch.float32, cuda)
    n0 = flash_attention.launches
    got = flash_attention.flash_attention_cuda(
        q, k, v, causal=causal, window=window, scale=d ** -0.5, t_actual=T)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [20, 72, 100, 250])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_any_head_dim_and_alignment(cuda, d, dtype):
    """Head dimensions that are not multiples of 8, and q, k, v viewed one
    element past an aligned start with odd row strides: element-by-element
    loads, zero-padded columns, element stores; the plain version's result
    at the sweep's limits, through each dtype's kernel."""
    B, H, K, S = 2, 4, 2, 77
    mod = ops.kernel_module("flash_attention", dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for offset in (0, 1):
        q = _normal((B, H, S, d + offset), 10 + d, dtype, cuda)[..., offset:]
        k = _normal((B, K, S, d + offset), 11 + d, dtype, cuda)[..., offset:]
        v = _normal((B, K, S, d + offset), 12 + d, dtype, cuda)[..., offset:]
        n0 = mod.launches
        for causal, window in ((True, None), (False, None), (True, 24)):
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
        torch.cuda.synchronize()
        assert mod.launches == n0 + 3


@pytest.mark.gpu
@pytest.mark.parametrize("P", [33, 63])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_odd_head_dim(cuda, P, dtype):
    """Odd P (rows of x and y not whole pairs), a ragged last chunk, and x
    viewed one element past an aligned start: the plain version's result
    at 1e-4, through each dtype's kernel."""
    B, H, S, N = 2, 3, 203, 16
    x, dt, A, bm, c = _ssd_inputs(B, H, S, P + 1, N, dtype, cuda, seed=P)
    x = x[..., 1:]
    mod = ops.kernel_module("ssd_scan", dtype)
    n0 = mod.launches
    y, h = ops.ssd_scan(x, dt, A, bm, c, return_state=True)
    want, want_h = ref.ssd_scan_ref(x, dt, A, bm, c, return_state=True)
    torch.cuda.synchronize()
    assert mod.launches == n0 + 1 and y.shape == (B, H, S, P)
    assert _rel(y, want) < 1e-4 and _rel(h, want_h) < 1e-4


@pytest.mark.gpu
def test_ssd_scan_tc32_at_the_prefill_shape(cuda):
    """mamba2-2.7b's prefill layer in float32 as the model hands it over,
    dt and A in Mamba-2's published ranges: y within 1e-4 per 256
    positions and the state within 1e-4 (phase 1c's limit), the same bits
    twice, while a scan that zeroes the carried state every 256 positions
    fails that limit; the comparator meets the same limit."""
    B, H, S, P, N = 4, 80, 2000, 64, 128
    rng = np.random.default_rng(10)
    xbc = torch.from_numpy(rng.standard_normal(
        (B, S, H * P + 2 * N)).astype(np.float32)).to(cuda)
    x = xbc[..., :H * P].reshape(B, S, H, P).transpose(1, 2)
    bm = xbc[..., H * P:H * P + N, None].transpose(2, 3).expand(
        B, S, H, N).transpose(1, 2)
    c = xbc[..., H * P + N:, None].transpose(2, 3).expand(
        B, S, H, N).transpose(1, 2)
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                             (B, S, H))).astype(
        np.float32)).to(cuda).transpose(1, 2)
    A = -torch.from_numpy(rng.uniform(1, 16, H).astype(np.float32)).to(cuda)
    n_f32, n_tc = ssd_scan_tc32.launches, ssd_scan_tc.launches
    y, h = ops.ssd_scan(x, dt, A, bm, c, return_state=True)
    y2, h2 = ops.ssd_scan(x, dt, A, bm, c, return_state=True)
    want, want_h = ref.ssd_scan_ref(x, dt, A, bm, c, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan_tc32.launches == n_f32 + 2
    assert ssd_scan_tc.launches == n_tc
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert _chunk_rel(y, want) < 1e-4 and _rel(h, want_h) < 1e-4
    zeroed = torch.cat([ref.ssd_scan_ref(
        x[:, :, s:s + 256], dt[:, :, s:s + 256], A, bm[:, :, s:s + 256],
        c[:, :, s:s + 256]) for s in range(0, S, 256)], dim=2)
    assert _chunk_rel(zeroed, want) > 1e-4
    y3, h3 = ssd_scan.ssd_scan_cuda(x, dt, A, bm, c)
    torch.cuda.synchronize()
    assert _chunk_rel(y3, want) < 1e-4 and _rel(h3, want_h) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_comparator_matches_plain_version(cuda, shape):
    """The earlier CUDA-core float32 scan, kept as a comparator, over the
    sweep at 1e-4."""
    args = _ssd_inputs(*shape, torch.float32, cuda)
    n0 = ssd_scan.launches
    y, h = ssd_scan.ssd_scan_cuda(*args)
    want, want_h = ref.ssd_scan_ref(*args, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == n0 + 1
    assert _rel(y, want) < 1e-4 and _rel(h, want_h) < 1e-4


# -- the Trainer on the card ---------------------------------------------------

@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _train(tcfg, device, data=None, **run):
    cfg = get_config("internlm2-1.8b", smoke=True)
    ds = SyntheticLM(cfg, batch=2, seq=32, microbatches=tcfg.microbatches,
                     seed=1)
    fixed = ds.batch_at(0)
    start = run.pop("start", 0)

    class Stream:
        step = start

        def __next__(self):
            Stream.step += 1
            return fixed if data == "fixed" else ds.batch_at(Stream.step - 1)

    tr = Trainer(cfg, AdamWConfig(lr=2e-3, warmup_steps=0, total_steps=100,
                                  weight_decay=0.0), tcfg, device=device)
    p, o = tr.run(Stream(), **run)
    losses = [m["loss"] for m in tr.metrics_log]
    restored = tr.restored_step
    tr.close()
    return p, o, losses, restored


@pytest.mark.gpu
def test_trainer_steps_are_deterministic(cuda, deterministic):
    tc = TrainConfig(steps=2, microbatches=2, log_every=0)
    p1, o1, l1, _ = _train(tc, cuda)
    p2, o2, l2, _ = _train(tc, cuda)
    assert l1 == l2
    for k in p1:
        assert torch.equal(p1[k], p2[k]) and torch.equal(o1["m"][k],
                                                         o2["m"][k]), k


@pytest.mark.gpu
def test_trainer_kill_restore_continue_is_exact(cuda, deterministic,
                                                tmp_path):
    pA, oA, lA, _ = _train(TrainConfig(steps=6, log_every=0), cuda)
    tcB = TrainConfig(steps=6, log_every=0, ckpt_dir=str(tmp_path / "ck"),
                      ckpt_every=2, ckpt_async=True)
    _train(tcB, cuda, stop_after=4)
    pC, oC, lC, restored = _train(tcB, cuda, start=4)
    assert restored == 4 and lC == lA[4:]
    for k in pA:
        assert torch.equal(pA[k], pC[k]), k
        assert torch.equal(oA["m"][k], oC["m"][k]), k
        assert torch.equal(oA["v"][k], oC["v"][k]), k
    assert torch.equal(oA["step"], oC["step"])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["compression", "offload"])
def test_trainer_modes_learn_a_fixed_batch(cuda, tmp_path, mode):
    tc = (TrainConfig(steps=20, compression=True, log_every=0)
          if mode == "compression" else
          TrainConfig(steps=10, mode="offload", log_every=0,
                      ckpt_dir=str(tmp_path / "oo"), ckpt_every=5))
    p, _, losses, _ = _train(tc, cuda, data="fixed")
    # the reference's limits (tests/test_train_serve.py)
    assert losses[-1] < losses[0] - (0.5 if mode == "compression" else 0.0), \
        losses
    assert all(v.device.type == "cuda" for v in p.values())


def test_trainer_needs_cuda_unless_cpu_is_asked():
    cfg = get_config("internlm2-1.8b", smoke=True)
    tc = TrainConfig(steps=1, log_every=0)
    if torch.cuda.is_available():
        assert Trainer(cfg, AdamWConfig(), tc).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(cfg, AdamWConfig(), tc)
    assert Trainer(cfg, AdamWConfig(), tc, device="cpu").device.type == "cpu"


# a value head dimension unlike the query's: (d, dv), MLA's first
DV_PAIRS = [(192, 128), (16, 8), (24, 40), (16, 256), (192, 256), (100, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize("d,dv", DV_PAIRS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_value_dim_on_the_card(cuda, d, dv, dtype):
    """Both tensor-core kernels with dv != d, in the model layout (v a
    strided view, as MLA's up-projection gives it), causal, windowed and
    with ``t_actual``, against the plain version at the sweep's limits;
    the output laid out as q."""
    rng = np.random.default_rng(d + dv)
    B, H, K, S = 2, 4, 2, 75

    def mk(heads, width, std):
        a = rng.standard_normal((B, S, heads, width)) * std
        return torch.from_numpy(a.astype(np.float32)).to(cuda, dtype)
    q, k = mk(H, d, 0.4).transpose(1, 2), mk(K, d, 0.4).transpose(1, 2)
    v = mk(K, dv + 8, 0.4)[..., 8:].transpose(1, 2)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for kw in (dict(causal=True), dict(causal=True, window=24),
               dict(causal=False, t_actual=50)):
        got = ops.flash_attention(q, k, v, scale=0.1, **kw)
        want = ref.flash_attention_ref(q, k, v, scale=0.1, **kw)
        assert got.shape == (B, H, S, dv)
        assert got.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
