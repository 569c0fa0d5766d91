"""The sharding rules against the reference's, on the CPU.

`spec_for`, `zero_spec` and `tree_specs` take the reference's
duck-typed meshes (an object whose `.shape` is {axis: size}) of 16 x 16,
2 x 16 x 16, 4 x 1 and 2 x 2; their specs must equal the reference's
entry for entry, for every parameter of every architecture (the port's
`param_axes`, whose stacked-layer leaves have no "layers" axis) and
every input and decode-cache leaf of the reference's STANDARD_SHAPES
cells.  `param_axes` itself must equal the reference's
`abstract_params()[1]`.  `placements` maps a spec to DTensor placements
and refuses a composite entry out of the mesh's order; `constrain`
redistributes a DTensor inside `activation_sharding` and leaves anything
else as it is."""

import datetime
import re
import socket

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro import configs as rconfigs
from repro.launch.steps import CACHE_AXES, INPUT_AXES
from repro.models import STANDARD_SHAPES, build as rbuild, input_specs
from repro.models.transformer import super_block_spec
from repro.runtime import sharding as R
from repro_torch import configs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import param_axes
from repro_torch.models.transformer import init_lm
from repro_torch.models.whisper import whisper_shapes
from repro_torch.runtime import sharding as T

torch.set_num_threads(1)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 1), ("data", "model")),
          ((2, 2), ("data", "model"))]


class FakeMesh:
    """The reference tests' duck-typed mesh: spec_for reads `.shape`."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape, strict=True))


def _ref_flat(tree, prefix=""):
    """The reference's nested tree -> {"a.b.c": leaf}, axes tuples kept."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_ref_flat(v, key + "."))
        else:
            out[key] = v
    return out


def _ref_params(cfg):
    """{port state-dict name: (axes, shape)} from the reference's
    abstract params, each stacked leaf unbound into its layers (its
    "layers" axis dropped)."""
    shapes, axes = rbuild(cfg).abstract_params()
    shapes = _ref_flat(shapes)
    out = {}
    for key, ax in _ref_flat(axes).items():
        shp = tuple(shapes[key].shape)
        if cfg.family == "encdec":
            m = re.fullmatch(r"(enc|dec)\.blocks\.(.*)", key)
            if m:
                for i in range(shp[0]):
                    out[f"{m[1]}.blocks.{i}.{m[2]}"] = (ax, shp)
                continue
        else:
            m = re.fullmatch(r"blocks\.b(\d+)\.(.*)", key)
            if m:
                per = len([k for k in super_block_spec(cfg)
                           if k != "shared"])
                for s in range(shp[0]):
                    out[f"blocks.{s * per + int(m[1])}.{m[2]}"] = (ax, shp)
                continue
        out[key] = (ax, shp)
    return out


def _port_shapes(cfg):
    if cfg.family == "encdec":
        return whisper_shapes(cfg)
    return {k: tuple(v.shape) for k, v in init_lm(cfg, None, "meta").items()}


@pytest.mark.parametrize("getter", ["get", "get_smoke"])
def test_param_axes_equal_the_references(getter):
    for name in configs.ARCHS:
        ref = _ref_params(getattr(rconfigs, getter)(name))
        want = {k: ax[1:] if ax[:1] == ("layers",) else ax
                for k, (ax, _) in ref.items()}
        assert param_axes(getattr(configs, getter)(name)) == want, name


@pytest.mark.parametrize("shape,axes", MESHES)
def test_parameter_specs_equal_the_references(shape, axes):
    mesh = FakeMesh(shape, axes)
    for name in configs.ARCHS:
        cfg = configs.get(name)
        ref = _ref_params(rconfigs.get(name))
        shapes = _port_shapes(cfg)
        specs = T.tree_specs(param_axes(cfg), shapes, mesh)
        assert specs.keys() == ref.keys() == shapes.keys(), name
        for key, (ax, shp) in ref.items():
            want = R.spec_for(ax, shp, mesh)
            stacked = ax[:1] == ("layers",)
            if stacked:         # the port's layer has no "layers" dim
                assert want[:1] in ((), (None,)), (name, key)
            assert tuple(specs[key]) == tuple(want)[stacked:], (name, key)
            zwant = R.zero_spec(want, shp, mesh)
            zgot = T.zero_spec(specs[key], shapes[key], mesh)
            if not stacked or zwant[:1] in ((), (None,)):
                assert tuple(zgot) == tuple(zwant)[stacked:], (name, key)


def _cache_leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _cache_leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("shape,axes", MESHES)
def test_input_and_cache_specs_equal_the_references(shape, axes):
    """Every input and decode-cache leaf of the reference's
    STANDARD_SHAPES cells, at those sizes, by the reference's logical
    axes tables."""
    mesh = FakeMesh(shape, axes)
    n = 0
    for name in configs.ARCHS:
        rcfg = rconfigs.get(name)
        model = rbuild(rcfg)
        for cell in STANDARD_SHAPES:
            for key, leaf in input_specs(rcfg, cell).items():
                ax, shp = INPUT_AXES[key], tuple(leaf.shape)
                assert tuple(T.spec_for(ax, shp, mesh)) == tuple(
                    R.spec_for(ax, shp, mesh)), (name, cell.name, key)
                n += 1
            if cell.kind != "decode":
                continue
            cache = jax.eval_shape(lambda m=model, c=cell: m.init_cache(
                c.global_batch, c.seq_len))
            for path, leaf in _cache_leaves(cache):
                shp = tuple(leaf.shape)
                ax = CACHE_AXES.get(path[-1], (None,) * len(shp))
                if len(ax) != len(shp):
                    ax = (None,) * len(shp)
                got = T.spec_for(ax, shp, mesh)
                want = R.spec_for(ax, shp, mesh)
                assert tuple(got) == tuple(want), (name, cell.name, path)
                assert tuple(T.zero_spec(got, shp, mesh)) == tuple(
                    R.zero_spec(want, shp, mesh)), (name, cell.name, path)
                n += 1
    assert n > 150


def test_rules_and_spec_type_follow_the_reference():
    assert T.DEFAULT_RULES == R.DEFAULT_RULES
    assert T.RuleSet().as_dict() == R.RuleSet().as_dict()
    over = dict(seq=(), batch="data", mlp=("model", "data"))
    assert T.RuleSet().override(**over) == T.RuleSet(
        R.RuleSet().override(**over).rules)
    mesh = FakeMesh((16, 16), ("data", "model"))
    rules = T.RuleSet().override(seq=())
    assert len(T.spec_for(("batch", "seq"), (256, 4096), mesh, rules)) == 1
    assert T.PartitionSpec(("model",), None) == ("model", None)
    assert T.PartitionSpec(("pod", "data")) == (("pod", "data"),)
    assert tuple(T.zero_spec(T.PartitionSpec("data"), (32,), mesh)) == (
        "data",)
    assert tuple(T.zero_spec(T.PartitionSpec(), (7, 3), mesh)) == ()
    assert repr(T.PartitionSpec("data", None)) == \
        "PartitionSpec('data', None)"


def test_mesh_helpers_and_card_constants():
    mesh = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert tmesh.mesh_axes(mesh) == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.mesh_chip_count(mesh) == 512
    # NVIDIA H100 80GB HBM3 (SXM): bf16 dense, HBM3, NVLink a direction
    assert (tmesh.PEAK_FLOPS, tmesh.HBM_BW, tmesh.HBM_BYTES,
            tmesh.NVLINK_BW) == (989e12, 3.35e12, 80e9, 450e9)


def test_placements_follow_the_mesh_order():
    mesh = FakeMesh((2, 4, 4), ("pod", "data", "model"))
    assert T.placements(T.PartitionSpec(("pod", "data"), "model"), mesh) \
        == (Shard(0), Shard(0), Shard(1))
    assert T.placements(T.PartitionSpec(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert T.placements(T.PartitionSpec(), mesh) == (Replicate(),) * 3
    # every default rule names its axes in the mesh's order
    spec = T.spec_for(("batch", "kv_seq"), (8, 64), mesh)
    assert tuple(spec) == (("pod", "data"), "model")
    assert T.placements(spec, mesh) == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="strided shard"):
        T.placements(T.PartitionSpec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        T.placements(T.PartitionSpec("stage"), mesh)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_constrain_redistributes_a_dtensor_inside_the_context():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    x = torch.ones((4, 4))
    assert T.constrain(x, ("batch", None)) is x
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=30))
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        assert T.constrain(d, ("batch", None)) is d
        with T.activation_sharding(mesh):
            assert T.constrain(x, ("batch", None)) is x
            got = T.constrain(d, ("batch", "mlp"))
            assert isinstance(got, DTensor)
            assert got.placements == (Shard(0), Shard(1))
            assert torch.equal(got.full_tensor(), x)
        assert T.constrain(d, ("batch", None)) is d
    finally:
        dist.destroy_process_group()
