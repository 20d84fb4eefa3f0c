"""The port's logical-axis rules against the JAX package's, on the CPU.

``repro_torch.runtime.sharding`` beside ``repro.runtime.sharding``: the rule
tables for every combination of ``train_rules``' ``multi_pod``, ``fsdp``,
``seq_shard`` and ``tp`` and of ``serve_rules``' ``multi_pod`` and
``kv_shard``; and ``logical_to_spec``'s spec and divisibility fallback
messages for every ``param_specs`` and ``init_cache_specs`` entry of every
arch in ``ARCHS``, under train and serve rules, on mesh shapes (16, 16),
(2, 16, 16), (2, 4) and (2, 2, 2) -- through an object with only a
``shape`` mapping, since both functions read only the size of each mesh
axis.  Then the port's own: ``explicit_spec`` (``logical_to_spec`` under
the training and the serving tables) and what it records,
``NamedSharding``'s blocks, ``shard``'s contract, the mesh factory's
refusals and ``use_rules``.
"""

import itertools
from types import SimpleNamespace

import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.models import init_cache_specs as ref_cache_specs
from repro.models import param_specs as ref_param_specs
from repro.runtime import sharding as ref
from repro_torch.configs import ARCHS, OFFLOAD_ARCHS, get_config
from repro_torch.launch.dryrun import serving_rules
from repro_torch.models import init_cache_specs, param_specs
from repro_torch.runtime import sharding as port

MESH_SHAPES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data",
                                                          "model"),
               (2, 4): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}


def _shape_mesh(shape):
    return SimpleNamespace(shape=dict(zip(MESH_SHAPES[shape], shape)))


def _rules(lib, kind, multi_pod):
    return (lib.train_rules(multi_pod) if kind == "train"
            else lib.serve_rules(multi_pod))


TRAIN_FLAGS = list(itertools.product((False, True), repeat=4))


@pytest.mark.parametrize("multi_pod,fsdp,seq_shard,tp", TRAIN_FLAGS)
def test_train_rules_equal_reference(multi_pod, fsdp, seq_shard, tp):
    kw = dict(fsdp=fsdp, seq_shard=seq_shard, tp=tp)
    a, b = port.train_rules(multi_pod, **kw), ref.train_rules(multi_pod, **kw)
    assert dict(a.rules) == dict(b.rules) and a.name == b.name
    assert set(a.rules) == set(port.LOGICAL_AXES) == set(ref.LOGICAL_AXES)


@pytest.mark.parametrize("multi_pod,kv_shard",
                         list(itertools.product((False, True),
                                                ("heads", "seq"))))
def test_serve_rules_equal_reference(multi_pod, kv_shard):
    a = port.serve_rules(multi_pod, kv_shard=kv_shard)
    b = ref.serve_rules(multi_pod, kv_shard=kv_shard)
    assert dict(a.rules) == dict(b.rules) and a.name == b.name


def _specs(cfg, lib_params, lib_cache):
    enc = cfg.enc_seq if cfg.is_encdec else 0
    return {**{f"param/{k}": v for k, v in lib_params(cfg).items()},
            **{f"cache/{k}": v for k, v in
               lib_cache(cfg, 32, 4096, enc).items()}}


@pytest.mark.parametrize("kind", ("train", "serve"))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logical_to_spec_equals_reference(arch, kind):
    """Every spec and every fallback message, on each mesh shape."""
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    cfg, rcfg = get_config(arch), ref_config(arch)
    ours = _specs(cfg, param_specs, init_cache_specs)
    theirs = _specs(rcfg, ref_param_specs, ref_cache_specs)
    assert list(ours) == list(theirs)
    for shape, axes in MESH_SHAPES.items():
        mesh = _shape_mesh(shape)
        multi_pod = len(axes) == 3
        rp, rr = _rules(port, kind, multi_pod), _rules(ref, kind, multi_pod)
        port.sharding_report().clear()
        ref.sharding_report().clear()
        for name, spec in ours.items():
            want = ref.logical_to_spec(theirs[name].axes, theirs[name].shape,
                                       rr, mesh, context=name)
            got = port.logical_to_spec(spec.axes, spec.shape, rp, mesh,
                                       context=name)
            assert tuple(got) == tuple(want), (shape, name, got, want)
            assert isinstance(got, port.PartitionSpec)
        assert port.sharding_report() == ref.sharding_report(), shape
    port.sharding_report().clear()
    ref.sharding_report().clear()


def test_logical_to_spec_without_rules_or_mesh():
    assert port.logical_to_spec(("batch", None)) == ()
    rules = port.train_rules()
    # no mesh: no shape check, as the reference's
    assert tuple(port.logical_to_spec(("batch", "heads"), (3, 5), rules)) \
        == tuple(ref.logical_to_spec(("batch", "heads"), (3, 5),
                                     ref.train_rules())) == ("data", "model")


def _batch_and_activation_specs(cfg):
    """The batch's logical axes (a leading microbatch axis) and the
    residual stream's, with shapes."""
    from repro_torch.configs import SHAPES, batch_specs
    out = {f"batch/{k}": ((None,) + s.axes, (2,) + s.shape)
           for k, s in batch_specs(cfg, SHAPES["train_4k"]).items()}
    out["activations"] = (("batch", "seq", "d_model"),
                          (256, 4096, cfg.d_model))
    return out


@pytest.mark.parametrize("multi_pod,tp,fsdp",
                         list(itertools.product((False, True), repeat=3)))
def test_explicit_spec_equals_logical_to_spec_under_train_rules(
        multi_pod, tp, fsdp):
    """Under every ``train_rules(multi_pod, tp=, fsdp=)`` table (and with
    ``seq_shard``), on each mesh shape, ``explicit_spec`` is
    ``logical_to_spec`` for every parameter, batch tensor and activation
    of every arch: the trainer holds the reference's blocks, and the step
    splits the residual stream where "seq" maps to an axis.  It adds
    nothing to the report: every mapping is applied (no "seq" mapping is
    left replicated since sequence and token parallelism)."""
    for shape, seq_shard in itertools.product(MESH_SHAPES, (False, True)):
        if len(shape) != (3 if multi_pod else 2):
            continue
        mesh = _shape_mesh(shape)
        rules = port.train_rules(multi_pod, tp=tp, fsdp=fsdp,
                                 seq_shard=seq_shard)
        seq = rules.mesh_axes("seq")
        for arch in ARCHS:
            cfg = get_config(arch)
            entries = {f"param/{k}": (s.axes, s.shape)
                       for k, s in param_specs(cfg).items()}
            entries.update(_batch_and_activation_specs(cfg))
            for ctx, (axes, shp) in entries.items():
                port.sharding_report().clear()
                want = port.logical_to_spec(axes, shp, rules, mesh, ctx)
                fallbacks = {k: list(v) for k, v in
                             port.sharding_report().items()}
                port.sharding_report().clear()
                got = port.explicit_spec(axes, shp, rules, mesh, ctx)
                report = dict(port.sharding_report())
                assert got == want, (arch, ctx, got, want)
                added = [m for m in report.get(ctx, [])
                         if m not in fallbacks.get(ctx, [])]
                assert added == [], (arch, ctx, added)
                if seq is not None and "seq" in axes:
                    assert got[axes.index("seq")] == (
                        seq if 4096 % mesh.shape[seq] == 0 else None)
    port.sharding_report().clear()


def test_explicit_spec_under_serve_rules_applies_batch_and_experts_only():
    """Under the serving rules on a (2, 4) mesh every mapping is applied,
    not the batch and the routed experts only: each of deepseek-v2's
    parameters keeps ``logical_to_spec``'s spec (its tensor-parallel
    dimensions over "model", the router's "experts" too), the batch keeps
    the data axes, and nothing is recorded beyond the divisibility
    fallbacks; a mapping to an axis of size 1 is no change, and is not
    recorded."""
    cfg = get_config("deepseek-v2-236b", smoke=True)
    mesh = _shape_mesh((2, 4))
    rules = port.serve_rules()
    port.sharding_report().clear()
    specs = {k: port.explicit_spec(s.axes, s.shape, rules, mesh, context=k)
             for k, s in param_specs(cfg).items()}
    report = dict(port.sharding_report())
    port.sharding_report().clear()
    for k, spec in specs.items():
        s = param_specs(cfg)[k]
        assert spec == port.logical_to_spec(s.axes, s.shape, rules, mesh), k
        leaf = k.split("/")[-1]
        if leaf.startswith("we_"):
            assert tuple(spec) == (None, "model"), (k, spec)
    assert tuple(specs["g1/p0/router"]) == (None, None, "model")
    assert tuple(specs["embed/tok"]) == ("model",)
    for msgs in report.values():
        assert all("not divisible" in m for m in msgs), msgs
    assert tuple(port.explicit_spec((None, "batch", None), (1, 8, 3),
                                    rules, mesh)) == (None, "data")
    one = SimpleNamespace(shape={"data": 1, "model": 1})
    assert tuple(port.explicit_spec(("heads", "ff"), (4, 4), rules,
                                    one)) == ("model",)
    assert port.sharding_report() == {}


@pytest.mark.parametrize("multi_pod,kv_shard,wsharded", list(
    itertools.product((False, True), ("heads", "seq"), (False, True))))
def test_explicit_spec_equals_logical_to_spec_under_serve_rules(
        multi_pod, kv_shard, wsharded):
    """Under ``serve_rules(multi_pod, kv_shard=)`` (and its ``/wsharded``
    form, "fsdp" over "data"), on each mesh shape, ``explicit_spec`` is
    ``logical_to_spec`` for every parameter, cache entry and batch tensor
    of every arch: prefill and decode hold the reference's blocks.  It
    records nothing beyond ``logical_to_spec``'s fallbacks."""
    from repro_torch.configs import SHAPES, batch_specs
    # the dry-run's rules for an offload arch are the /wsharded ones
    rules = serving_rules(OFFLOAD_ARCHS[0] if wsharded else "gemma-7b",
                          multi_pod, kv_shard)
    assert rules.name.endswith("/wsharded") == wsharded
    for shape in MESH_SHAPES:
        if len(shape) != (3 if multi_pod else 2):
            continue
        mesh = _shape_mesh(shape)
        for arch in ARCHS:
            cfg = get_config(arch)
            entries = {ctx: (s.axes, s.shape) for ctx, s in _specs(
                cfg, param_specs, init_cache_specs).items()}
            entries.update({f"batch/{k}": (s.axes, s.shape) for k, s in
                            batch_specs(cfg, SHAPES["prefill_32k"]).items()})
            for ctx, (axes, shp) in entries.items():
                port.sharding_report().clear()
                want = port.logical_to_spec(axes, shp, rules, mesh, ctx)
                fallbacks = {k: list(v) for k, v in
                             port.sharding_report().items()}
                port.sharding_report().clear()
                got = port.explicit_spec(axes, shp, rules, mesh, ctx)
                assert got == want, (arch, ctx, got, want)
                assert port.sharding_report() == fallbacks, (arch, ctx)
    port.sharding_report().clear()


@pytest.mark.parametrize("spec", [port.PartitionSpec(("data", "model")),
                                  port.PartitionSpec("data", "model"),
                                  port.PartitionSpec(None, ("model", "data")),
                                  port.PartitionSpec()])
def test_named_sharding_blocks_tile_the_tensor(spec):
    mesh = SimpleNamespace(shape={"data": 2, "model": 2})
    sh = port.NamedSharding(mesh, spec)
    t = torch.arange(8 * 12).reshape(8, 12)
    blocks = {}
    for d, m in itertools.product(range(2), range(2)):
        blk = sh.local_slice(t, {"data": d, "model": m})
        assert tuple(blk.shape) == sh.shard_shape(t.shape)
        blocks[d, m] = blk
    seen = torch.zeros_like(t)
    for blk in blocks.values():  # each element held by as many ranks as
        seen.view(-1)[blk.reshape(-1)] += 1  # its spec replicates it
    used = [a for p in spec if p
            for a in ((p,) if isinstance(p, str) else p)]
    assert torch.all(seen == 4 // 2 ** len(used)), (spec, seen)
    if tuple(spec) == (("data", "model"),):  # row-major over the axes
        assert torch.equal(torch.cat([blocks[d, m] for d in range(2)
                                      for m in range(2)]), t)
    with pytest.raises(ValueError):
        port.NamedSharding(mesh, port.PartitionSpec("data")).shard_shape((3,))


def test_shard_keeps_the_reference_contract():
    x = torch.zeros(6, 4)
    assert port.shard(x, ("batch",)) is x  # no rules, no mesh: nothing
    mesh = SimpleNamespace(shape={"data": 4, "model": 2})
    port.sharding_report().clear()
    with port.use_rules(port.train_rules(), mesh):
        with pytest.raises(ValueError, match="rank-2"):
            port.shard(x, ("batch",), "t")
        assert port.shard(x, ("batch", "heads"), "t") is x
    assert port.sharding_report() == {
        "t": ["axis 'batch' dim 6 not divisible by ('data',)=4; "
              "replicated"]}
    port.sharding_report().clear()


def test_use_rules_nests_and_restores():
    m1, m2 = SimpleNamespace(shape={"data": 1}), SimpleNamespace(shape={})
    r = port.train_rules()
    assert port.current_rules() is None and port.current_mesh() is None
    with port.use_rules(r, m1):
        with port.use_rules(None, m2):
            assert port.current_rules() is None and port.current_mesh() is m2
        assert port.current_rules() is r and port.current_mesh() is m1
        assert port.batch_axes(SimpleNamespace(
            shape={"pod": 2, "data": 2, "model": 2})) == ("data",)
    assert port.current_mesh() is None
    assert port.batch_axes(SimpleNamespace(
        shape={"pod": 2, "data": 2, "model": 2})) == ("pod", "data")


def test_mesh_needs_a_process_group_of_its_size():
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_production_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh((1, 1), ("data", "model"), device="cuda")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 4 processes"):
            make_mesh((2, 2), ("data", "model"), device="cpu")
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        assert port.mesh_shape(mesh) == {"data": 1, "model": 1}
        assert port.mesh_coords(mesh) == {"data": 0, "model": 0}
    finally:
        dist.destroy_process_group()
