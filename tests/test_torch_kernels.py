"""The port's diff kernels against the JAX package's, bit for bit.

On the CPU the port's wrappers run the kernels' plain PyTorch versions;
they are held here to ``repro.kernels.ops`` run with ``impl='ref'`` and
``impl='interpret'`` (the Pallas kernels interpreted on the CPU), over the
sweeps of ``tests/test_kernels.py`` (float32/bfloat16/int8/int32, aligned,
odd and ragged blocks, NaN).  Inputs are numpy arrays made from a seed;
bfloat16 inputs are uint16 bit patterns viewed as bfloat16 on both sides,
never rounded through float32.  The CUDA kernels themselves run only on the
card: ``tests/test_torch_gpu.py`` holds them to the plain versions there.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.dirty_diff import changed_elem_spans as j_spans
from repro.kernels.pack_diff import packed_run_layout as j_layout
from repro_torch.convert import tree_from_numpy
from repro_torch.kernels import _build, dirty_diff, ops, pack_diff

DTYPES = ["float32", "bfloat16", "int8", "int32"]


def _random(rng, dtype: str, n: int) -> np.ndarray:
    """``n`` random values of ``dtype`` (bfloat16 as bit patterns)."""
    if dtype == "bfloat16":
        bits = rng.integers(0, 1 << 16, size=n, dtype=np.uint16)
        bits[(bits & 0x7F80) == 0x7F80] &= 0x3FFF  # no NaN/inf patterns
        return bits.view(ml_dtypes.bfloat16)
    if dtype == "float32":
        return (rng.standard_normal(n) * 4).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -100), min(info.max, 100), size=n,
                        dtype=dtype)


def _bump(a: np.ndarray, idx) -> np.ndarray:
    """Copy of ``a`` with the bit pattern of each element at ``idx``
    changed (lowest bit flipped)."""
    bits = a.view(f"uint{a.dtype.itemsize * 8}").copy()
    bits[np.asarray(idx, dtype=np.int64)] ^= 1
    return bits.view(a.dtype)


def _t(a: np.ndarray) -> torch.Tensor:
    return tree_from_numpy({"a": a}, device="cpu")["a"]


def _bytes_of(x) -> np.ndarray:
    """Row-major bytes of a jax array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def _check_pack(cur, snap, block_elems, impl):
    """Port vs reference ``dirty_pack``: flags, count, packed[:count]."""
    jf, jp, jc = jops.dirty_pack(jnp.asarray(cur), jnp.asarray(snap),
                                 block_elems=block_elems, tile_elems=64,
                                 impl=impl)
    tf, tp, tc = ops.dirty_pack(_t(cur), _t(snap), block_elems=block_elems)
    assert tf.dtype == torch.int32 and tc.dtype == torch.int32
    assert tf.numpy().tolist() == np.asarray(jf).tolist()
    k = int(np.asarray(jc)[0])
    assert int(tc[0]) == k
    assert tp.shape == (len(tf), block_elems) and tp.dtype == _t(cur).dtype
    assert (_bytes_of(tp[:k]) == _bytes_of(jp[:k])).all()
    return tf.numpy()


# -- dirty_blocks ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_dirty_diff_sweep(dtype):
    rng = np.random.default_rng(10)
    cur = _random(rng, dtype, 7 * 512)
    snap = _bump(cur, [2 * 512 + 17, 5 * 512])
    want = jops.dirty_blocks(jnp.asarray(cur), jnp.asarray(snap),
                             block_elems=512, impl="interpret")
    got = ops.dirty_blocks(_t(cur), _t(snap), block_elems=512)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist() == [0, 0, 1, 0, 0, 1, 0]


def _matrix_case(dtype, block_elems, n, pattern, seed):
    rng = np.random.default_rng(seed)
    snap = _random(rng, dtype, n)
    nblocks = -(-n // block_elems)
    dirty = {"sparse": sorted({0, nblocks // 2, nblocks - 1}),
             "all_dirty": list(range(nblocks)), "all_clean": []}[pattern]
    idx = [min(b * block_elems + (b % block_elems), n - 1) for b in dirty]
    return _bump(snap, idx), snap, dirty, nblocks


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_elems,n", [(128, 1024), (96, 960), (100, 930)])
@pytest.mark.parametrize("pattern", ["sparse", "all_clean", "all_dirty"])
def test_dirty_blocks_matrix_matches_reference(dtype, block_elems, n, pattern):
    cur, snap, dirty, nblocks = _matrix_case(dtype, block_elems, n, pattern,
                                             n + block_elems)
    got = ops.dirty_blocks(_t(cur), _t(snap), block_elems=block_elems)
    want = np.zeros(nblocks, np.int32)
    want[dirty] = 1
    assert got.tolist() == want.tolist()
    for impl in ("ref", "interpret"):
        j = jops.dirty_blocks(jnp.asarray(cur), jnp.asarray(snap),
                              block_elems=block_elems, tile_elems=64,
                              impl=impl)
        assert got.tolist() == np.asarray(j).tolist(), impl


@pytest.mark.parametrize("impl", ["interpret", "ref"])
def test_dirty_diff_nan_block_stays_clean(impl):
    cur = np.zeros((3, 500), np.float32)
    cur[1, 499] = np.nan
    cur[0, :] = np.nan  # a whole unchanged NaN block
    snap = cur.copy()
    snap[2, 0] += 1.0
    got = ops.dirty_blocks(_t(cur.reshape(-1)), _t(snap.reshape(-1)),
                           block_elems=500)
    want = jops.dirty_blocks(jnp.asarray(cur.reshape(-1)),
                             jnp.asarray(snap.reshape(-1)), block_elems=500,
                             tile_elems=128, impl=impl)
    assert got.tolist() == np.asarray(want).tolist() == [0, 0, 1]


# -- dirty_pack ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_elems,n", [(128, 1024), (96, 960), (100, 930)])
@pytest.mark.parametrize("pattern", ["sparse", "all_clean", "all_dirty"])
@pytest.mark.parametrize("impl", ["ref", "interpret"])
def test_dirty_pack_matrix_matches_reference(dtype, block_elems, n, pattern,
                                             impl):
    cur, snap, dirty, nblocks = _matrix_case(dtype, block_elems, n, pattern,
                                             n * 3 + block_elems)
    flags = _check_pack(cur, snap, block_elems, impl)
    assert np.flatnonzero(flags).tolist() == dirty


@pytest.mark.parametrize("impl", ["interpret", "ref"])
def test_dirty_pack_nan_and_layout(impl):
    cur = np.zeros((4, 500), np.float32)
    cur[1, 499] = np.nan
    snap = cur.copy()
    snap[2, 0] += 1.0
    snap[3, 10] += 2.0
    flags = _check_pack(cur.reshape(-1), snap.reshape(-1), 500, impl)
    assert flags.tolist() == [0, 0, 1, 1]
    runs = pack_diff.packed_run_layout(flags.astype(bool), 500, 2000)
    assert runs == j_layout(flags.astype(bool), 500, 2000) == [(1000, 2000, 0)]


def test_dirty_pack_ragged_tail_is_zero_padded():
    """In the short last block, elements past the tensor's end are zero in
    the packed row, as the reference's zero padding leaves them."""
    cur = np.arange(1, 251, dtype=np.int32)
    snap = cur.copy()
    snap[-1] = 0  # only the last (short) block changes
    flags, packed, count = ops.dirty_pack(_t(cur), _t(snap), block_elems=100)
    assert flags.tolist() == [0, 0, 1] and count.tolist() == [1]
    assert packed[0, :50].tolist() == list(range(201, 251))
    assert not packed[0, 50:].any()


# -- span geometry -----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_span_geometry_matches_reference(seed):
    rng = np.random.default_rng(seed)
    flags = rng.random(37) < 0.3
    nelems = 37 * 64 - int(rng.integers(0, 64))
    assert dirty_diff.changed_elem_spans(flags, 64, nelems) == \
        j_spans(flags, 64, nelems)
    assert pack_diff.packed_run_layout(flags, 64, nelems) == \
        j_layout(flags, 64, nelems)


# -- the CUDA side of the wrappers, without a card -----------------------------

def test_plain_versions_on_cpu_launch_nothing():
    """CPU tensors take the plain versions: no build, no launch."""
    before = (dirty_diff.launches, pack_diff.launches)
    a = torch.zeros(4096)
    ops.dirty_blocks(a, a)
    ops.dirty_pack(a, a)
    assert (dirty_diff.launches, pack_diff.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch for CUDA tensors or raise: never a
    silent fallback."""
    a = torch.zeros(4096, dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        dirty_diff.dirty_diff_cuda(a, a, 4096)
    with pytest.raises(ValueError, match="CUDA"):
        pack_diff.diff_pack_cuda(a, a, 4096)


def test_pair_validation():
    a = torch.zeros(16)
    with pytest.raises(ValueError, match="shape"):
        ops.dirty_blocks(a, a[:-1])
    with pytest.raises(ValueError, match="dtype"):
        ops.dirty_pack(a, a.to(torch.float64))


def test_build_layout():
    """Sources compile for sm_90a into the git-ignored build directory."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in ("dirty_diff", "pack_diff"):
        assert _build.source_path(name).is_file()
    root = _build.SOURCES.parents[2]
    assert _build.BUILD_DIR == root / "build" / "repro_torch"
    assert "build/" in (root / ".gitignore").read_text().split()
