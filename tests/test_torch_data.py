"""The port's data pipeline and cell shapes against the JAX package's.

``SyntheticLM`` batches must be byte-equal (numpy ``SeedSequence([seed,
step, rank])`` on both sides), ``WindowBackedDataset`` must write the same
file and read the same tokens, ``make_batch_iter`` must keep the source's
order, and ``SHAPES`` / ``batch_specs`` / ``decode_specs`` /
``cache_len_for`` / ``shape_applicable`` must equal the reference's.
"""

import dataclasses

import numpy as np
import pytest

import repro.configs as jconfigs
import repro.core as jcore
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import WindowBackedDataset as JWindowBackedDataset
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
from repro_torch.data import SyntheticLM, WindowBackedDataset, make_batch_iter

ARCHS = ("internlm2-1.8b", "mamba2-2.7b", "recurrentgemma-2b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mb,rank", [(1, 0), (3, 2)])
def test_synthetic_batches_byte_equal(arch, mb, rank):
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = tconfigs.get_config(arch, smoke=True)
    want = JSyntheticLM(jcfg, batch=2, seq=24, microbatches=mb, seed=5,
                        rank=rank)
    got = SyntheticLM(cfg, batch=2, seq=24, microbatches=mb, seed=5,
                      rank=rank)
    for step in (0, 1, 17):
        w, g = want.batch_at(step), got.batch_at(step)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            assert g[k].tobytes() == w[k].tobytes()
        assert (g["targets"][..., -1] == -1).all()
    it = iter(got)
    assert next(it)["inputs"].tobytes() == got.batch_at(0)["inputs"].tobytes()


@pytest.mark.parametrize("change", [{"frontend": "vlm_stub"},
                                    {"enc_layers": 2}])
def test_synthetic_refuses_frontend_batches(change):
    """The frontends' batches, once refused naming A12, are ported: a VLM's
    ``patches`` (``seq`` counts them) and an encoder-decoder model's
    ``frames``, drawn after the tokens from the same generator, byte-equal
    to the reference's (the same change on both packages' configs)."""
    if change.get("frontend") == "vlm_stub":
        change = dict(change, img_tokens=8)
    jcfg = dataclasses.replace(jconfigs.get_config("internlm2-1.8b",
                                                   smoke=True), **change)
    cfg = dataclasses.replace(tconfigs.get_config("internlm2-1.8b",
                                                  smoke=True), **change)
    for mb, rank in ((1, 0), (3, 2)):
        want = JSyntheticLM(jcfg, batch=2, seq=24, microbatches=mb, seed=5,
                            rank=rank)
        got = SyntheticLM(cfg, batch=2, seq=24, microbatches=mb, seed=5,
                          rank=rank)
        for step in (0, 17):
            w, g = want.batch_at(step), got.batch_at(step)
            assert sorted(g) == sorted(w)
            assert ("patches" in g) == ("frontend" in change)
            assert ("frames" in g) == ("enc_layers" in change)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                assert g[k].tobytes() == w[k].tobytes(), k
    if "frontend" in change:
        assert g["inputs"].shape[-1] == 24 - 8
        assert g["patches"].shape == (3, 2, 8, cfg.d_model)
    else:
        assert g["frames"].shape == (3, 2, 24, cfg.d_model)


def test_window_backed_dataset_file_and_reads(tmp_path):
    corpus = np.random.default_rng(0).integers(0, 512, 1000).astype(np.int32)
    files, reads = [], []
    for core, cls, name in ((jcore, JWindowBackedDataset, "ref.bin"),
                            (tcore, WindowBackedDataset, "port.bin")):
        comm = core.Communicator(2)
        ds = cls(comm, str(tmp_path / name), 500)
        for r in range(2):
            ds.write_corpus(r, corpus[r * 500:(r + 1) * 500])
        reads.append([ds.read(1, 37, 16).tobytes(),
                      ds.batch_at(0, 3, 2, 8)["inputs"].tobytes(),
                      ds.batch_at(1, 5, 2, 8)["targets"].tobytes()])
        ds.free()
        comm.close()
        files.append((tmp_path / name).read_bytes())
    assert files[0] == files[1]
    assert reads[0] == reads[1]


def test_make_batch_iter_keeps_order():
    items = [{"i": np.asarray(i)} for i in range(10)]
    got = [int(b["i"]) for b in make_batch_iter(iter(items), prefetch=2)]
    assert got == list(range(10))


def test_shapes_and_specs_equal():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in ARCHS:
        jcfg, cfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        for name in jconfigs.SHAPES:
            js, ts = jconfigs.SHAPES[name], tconfigs.SHAPES[name]
            assert tconfigs.shape_applicable(cfg, ts) == \
                jconfigs.shape_applicable(jcfg, js)
            assert tconfigs.cache_len_for(cfg, ts) == \
                jconfigs.cache_len_for(jcfg, js)
            for fn in ("batch_specs", "decode_specs"):
                want = getattr(jconfigs, fn)(jcfg, js)
                got = getattr(tconfigs, fn)(cfg, ts)
                assert {k: (v.shape, v.dtype, v.axes) for k, v in got.items()} \
                    == {k: (v.shape, v.dtype, v.axes) for k, v in want.items()}
