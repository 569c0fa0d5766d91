"""The model cell against the reference's, on the CPU.

`input_specs`, `cache_specs`, `abstract_params` and `abstract_opt_state`
against the reference's keys, shapes and dtypes for every arch and
STANDARD_SHAPE; `build_cell`'s shardings against the reference's
`build_cell` entry for entry (the oracle in a JAX process of 8 forced
host devices inside `jax.set_mesh` on a (4, 2) mesh), for every arch,
each kind, with and without FSDP; the same specs over the production
meshes built in a fake world of 256 and 512 ranks (a subprocess, since
the default process group is global), against the reference's
`spec_for` / `zero_spec` on a duck-typed mesh of the same shape, with a
meta DTensor built at each leaf's placements; `apply_variant` against the
reference's for all 18 forms and a composition; the argument bytes a
device holds on the (32, 8) mesh; and the models' sharding constraints,
which change nothing without a mesh.

The port keeps one tensor per layer where the reference stacks the
layers, so a stacked leaf's reference spec has one entry more (the
"layers" dim, never sharded by the rules).  Where the reference's ZeRO
spec puts "data" on that dim, the port puts it on the leaf's largest
replicated dim that divides (`zero_spec` of the port's own shape), or
leaves it replicated; those leaves are named in LAYERS_DIM_ZERO."""

import inspect
import json
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from test_torch_sharding import FakeMesh, _ref_params
from torch_world import ROOT, finish, start_jax

from repro import configs as rconfigs
from repro.launch import variants as rvariants
from repro.launch.steps import CACHE_AXES as R_CACHE_AXES
from repro.launch.steps import INPUT_AXES as R_INPUT_AXES
from repro.models import STANDARD_SHAPES as R_SHAPES
from repro.models import build as rbuild
from repro.models import input_specs as r_input_specs
from repro.optim.adamw import abstract_opt_state as r_abstract_opt_state
from repro.runtime import sharding as R
from repro_torch import configs
from repro_torch.launch import variants
from repro_torch.launch.hlo_analysis import argument_bytes
from repro_torch.launch.mesh import HBM_BYTES
from repro_torch.launch.steps import (CACHE_AXES, INPUT_AXES, CellStep,
                                      build_cell)
from repro_torch.models import (SHAPES_BY_NAME, STANDARD_SHAPES, ShapeSpec,
                                abstract_params, build, cache_specs,
                                input_specs)
from repro_torch.optim.adamw import abstract_opt_state
from repro_torch.runtime import sharding as T

torch.set_num_threads(1)

KINDS = ("train_4k", "prefill_32k", "decode_32k")

# (arch, port leaf) where the reference's ZeRO spec shards the stacked
# "layers" dim over "data" on the (4, 2) mesh: the port shards the
# leaf's own largest replicated dim instead, or leaves it replicated
LAYERS_DIM_ZERO = {
    ("llama_3_2_vision_90b", "blocks.*.gate"),
    ("mamba2_130m", "blocks.*.ssm.A_log"),
    ("mamba2_130m", "blocks.*.ssm.D"),
    ("mamba2_130m", "blocks.*.ssm.conv_x"),
    ("mamba2_130m", "blocks.*.ssm.dt_bias"),
    ("mamba2_130m", "blocks.*.ssm.norm"),
}


def _dt(d) -> str:
    return str(d).removeprefix("torch.")


def _meta_desc(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_meta_desc(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), _dt(v.dtype))
    return out


@pytest.mark.parametrize("name", list(configs.ARCHS))
def test_abstract_specs_equal_the_references(name):
    """Keys, shapes and dtypes of the inputs, the decode cache, the
    parameters and the train state, for every STANDARD_SHAPE."""
    cfg, rcfg = configs.get(name), rconfigs.get(name)
    assert [tuple(vars(s).values()) for s in STANDARD_SHAPES] == \
        [tuple(vars(s).values()) for s in R_SHAPES]
    assert SHAPES_BY_NAME["decode_32k"] == ShapeSpec(
        "decode_32k", 32_768, 128, "decode")
    rmodel = rbuild(rcfg)
    for shape, rshape in zip(STANDARD_SHAPES, R_SHAPES, strict=True):
        got = _meta_desc(input_specs(cfg, shape))
        assert got == _meta_desc(r_input_specs(rcfg, rshape)), shape.name
        if shape.kind != "decode":
            continue
        want = _meta_desc(jax.eval_shape(lambda s=rshape: rmodel.init_cache(
            s.global_batch, s.seq_len)))
        cache = cache_specs(cfg, shape)
        assert all(t.device.type == "meta" for t in
                   jax.tree.leaves(cache))
        assert _meta_desc(cache) == want, shape.name
    params, axes = abstract_params(cfg)
    ref = _ref_params(rcfg)
    rshapes, _ = rmodel.abstract_params()
    pdt = _dt(jax.tree.leaves(rshapes)[0].dtype)
    assert params.keys() == ref.keys() == axes.keys()
    for key, (ax, shp) in ref.items():
        stacked = ax[:1] == ("layers",)
        assert tuple(params[key].shape) == shp[stacked:], key
        assert params[key].device.type == "meta"
        assert _dt(params[key].dtype) == pdt, key
    st = abstract_opt_state(params, cfg.optimizer_dtype)
    rst = r_abstract_opt_state(rshapes, rcfg.optimizer_dtype)
    mdt = _dt(jax.tree.leaves(rst.m)[0].dtype)
    for tree in (st.m, st.v):
        assert tree.keys() == params.keys()
        assert all(tuple(tree[k].shape) == tuple(params[k].shape)
                   and _dt(tree[k].dtype) == mdt
                   and tree[k].device.type == "meta" for k in tree)
    for t, r in ((st.step, rst.step), (st.dyn_counter, rst.dyn_counter)):
        assert (tuple(t.shape), _dt(t.dtype)) == (tuple(r.shape),
                                                  _dt(r.dtype))


def test_abstract_params_allocate_nothing():
    import time

    t0 = time.perf_counter()
    for name in ("mistral_large_123b", "llama4_maverick_400b_a17b"):
        params, _ = abstract_params(configs.get(name))
        assert all(p.device.type == "meta" for p in params.values())
    assert time.perf_counter() - t0 < 1.0


def _spec_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _port_flat(args, shards, kind) -> dict:
    """{"i/…": (spec as JSON, shape)} of a port cell's arguments."""
    out = {}

    def walk(prefix, spec, shard):
        if isinstance(shard, T.NamedSharding):
            out[prefix] = (_spec_json(shard.spec), list(spec.shape))
        elif isinstance(shard, dict):
            for k, v in shard.items():
                walk(f"{prefix}/{k}", spec[k], v)
        else:                                   # TrainState
            for f in ("params", "m", "v", "step", "dyn_counter"):
                walk(f"{prefix}/{f}", getattr(spec, f), getattr(shard, f))

    for i, (a, s) in enumerate(zip(args, shards, strict=True)):
        if kind != "train" and i == 0:
            for k, v in s.items():
                out[f"0/params/{k}"] = (_spec_json(v.spec),
                                        list(a[k].shape))
        else:
            walk(str(i), a, s)
    return out


def _expand_ref(cfg, flat: dict, kind: str) -> dict:
    """The oracle's {path: (spec, shape)} with every stacked parameter
    (and moment) leaf unbound into the port's layers: its "layers" entry
    dropped, its key the port's state-dict name."""
    from repro.models.transformer import super_block_spec

    out = {}
    for path, (spec, shape) in flat.items():
        parts = path.split("/")
        if kind != "train" and parts[0] == "0":
            parts = ["0", "params"] + parts[1:]
        if parts[0] != "0" or len(parts) == 2:
            out["/".join(parts)] = (spec, shape)
            continue
        head, key = "/".join(parts[:2]), ".".join(parts[2:])
        m = (re.fullmatch(r"(enc|dec)\.blocks\.(.*)", key)
             if cfg.family == "encdec" else
             re.fullmatch(r"blocks\.b(\d+)\.(.*)", key))
        if m is None:
            out[f"{head}/{key}"] = (spec, shape)
            continue
        if cfg.family == "encdec":
            names = [f"{m[1]}.blocks.{i}.{m[2]}" for i in range(shape[0])]
        else:
            per = len([k for k in super_block_spec(cfg) if k != "shared"])
            names = [f"blocks.{s * per + int(m[1])}.{m[2]}"
                     for s in range(shape[0])]
        for n in names:
            out[f"{head}/{n}"] = (spec, shape, "stacked")
    return out


ORACLE = """
import json
import jax
from repro import configs
from repro.models import SHAPES_BY_NAME
from repro.launch.steps import build_cell

def key(p):
    for a in ("key", "name", "idx"):
        if hasattr(p, a):
            return str(getattr(p, a))
    raise TypeError(p)

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]

mesh = jax.make_mesh((4, 2), ("data", "model"))
out = {}
with jax.set_mesh(mesh):
    for name in configs.ARCHS:
        for shape in KINDS:
            for fsdp in (True, False):
                _, args, shards, _ = build_cell(
                    configs.get(name), SHAPES_BY_NAME[shape], mesh,
                    fsdp=fsdp)
                sh = jax.tree_util.tree_flatten_with_path(shards)[0]
                ar = jax.tree.leaves(args)
                out[f"{name}|{shape}|{fsdp}"] = {
                    "/".join(key(p) for p in path): (spec(s.spec),
                                                     list(a.shape))
                    for (path, s), a in zip(sh, ar, strict=True)}
json.dump(out, open(OUT + "/cells.json", "w"))
"""


def test_build_cell_specs_equal_the_references(tmp_path):
    """Every argument's spec, entry for entry, on a (4, 2) mesh: all
    archs, the train / prefill / decode kinds, fsdp on and off."""
    proc = start_jax(f"KINDS = {KINDS!r}\n" + ORACLE, tmp_path, devices=8)
    mesh = FakeMesh((4, 2), ("data", "model"))
    ports = {}
    for name in configs.ARCHS:
        for shape in KINDS:
            for fsdp in (True, False):
                cell = SHAPES_BY_NAME[shape]
                fn, args, shards, out = build_cell(configs.get(name), cell,
                                                   mesh, fsdp=fsdp)
                assert isinstance(fn, CellStep) and out is None
                assert fn.model.embed.device.type == "meta"
                ports[f"{name}|{shape}|{fsdp}"] = _port_flat(args, shards,
                                                             cell.kind)
    finish(proc, timeout=120)
    refs = json.load(open(tmp_path / "cells.json"))
    assert refs.keys() == ports.keys()
    limit, n = set(), 0
    for cell, ref in refs.items():
        name, shape, _ = cell.split("|")
        cfg = rconfigs.get(name)
        want = _expand_ref(cfg, ref, SHAPES_BY_NAME[shape].kind)
        got = ports[cell]
        assert got.keys() == want.keys(), cell
        for path, (spec, shp, *stacked) in want.items():
            gspec, gshape = got[path]
            if not stacked:
                assert (gspec, gshape) == (spec, shp), (cell, path)
                continue
            assert gshape == shp[1:], (cell, path)
            if spec[:1] in ([], [None]):
                assert gspec == spec[1:], (cell, path)
            else:                   # "data" on the stacked layers dim
                assert spec[0] == "data", (cell, path)
                leaf = re.sub(r"\.\d+\.", ".*.", path.split("/", 2)[2])
                limit.add((name, leaf))
                own = T.zero_spec(T.PartitionSpec(*[
                    tuple(e) if isinstance(e, list) else e
                    for e in spec[1:]]), gshape, mesh)
                assert gspec == _spec_json(own), (cell, path)
            n += 1
    assert limit == LAYERS_DIM_ZERO
    assert n > 10_000


def _ref_expected(cfg, rcfg, cell, mesh, fsdp: bool) -> dict:
    """The reference's specs of a cell over a duck-typed mesh, by its
    `spec_for` / `zero_spec`, keyed as `_port_flat` keys the port's (the
    layers-dim ZeRO leaves as the port places them)."""
    out = {}
    rshape = next(s for s in R_SHAPES if s.name == cell.name)
    for key, (ax, shp) in _ref_params(rcfg).items():
        stacked = ax[:1] == ("layers",)
        spec = R.spec_for(ax, shp, mesh)
        z = R.zero_spec(spec, shp, mesh)
        if stacked and z[:1] not in ((), (None,)):
            z = R.zero_spec(spec, (1,) + shp[1:], mesh)
        p = z if fsdp else spec
        out[f"0/params/{key}"] = (_spec_json(tuple(p)[stacked:]),
                                  list(shp[stacked:]))
        if cell.kind == "train":
            for f in ("m", "v"):
                out[f"0/{f}/{key}"] = (_spec_json(tuple(z)[stacked:]),
                                       list(shp[stacked:]))
    if cell.kind == "train":
        out["0/step"] = out["0/dyn_counter"] = ([], [])
    if cell.kind != "decode":
        for k, v in r_input_specs(rcfg, rshape).items():
            out[f"1/{k}"] = (_spec_json(R.spec_for(R_INPUT_AXES[k],
                                                   v.shape, mesh)),
                             list(v.shape))
        return out
    b = cell.global_batch
    out["1"] = (_spec_json(R.spec_for(("batch", None), (b, 1), mesh)),
                [b, 1])
    out["3"] = ([], [])
    cache = jax.eval_shape(lambda: rbuild(rcfg).init_cache(b, cell.seq_len))
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        names = [str(p.key) for p in path]
        ax = R_CACHE_AXES.get(names[-1], (None,) * leaf.ndim)
        if len(ax) != leaf.ndim:
            ax = (None,) * leaf.ndim
        out["2/" + "/".join(names)] = (
            _spec_json(R.spec_for(ax, leaf.shape, mesh)), list(leaf.shape))
    if cfg.family == "vlm":
        img = r_input_specs(rcfg, rshape)["image_embeds"]
        out["4"] = (_spec_json(R.spec_for(R_INPUT_AXES["image_embeds"],
                                          img.shape, mesh)),
                    list(img.shape))
    return out


PRODUCTION = """
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import configs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell, _zeros
from repro_torch.models import SHAPES_BY_NAME
from repro_torch.runtime import sharding as T
from repro_torch.runtime.sharding import NamedSharding

KINDS = {kinds!r}
{helpers}

multi = {multi}
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size=512 if multi else 256)
mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
out, built = {{}}, 0

def leaves(spec, shard):
    if isinstance(shard, NamedSharding):
        yield spec, shard
    elif isinstance(shard, dict):
        for k, v in shard.items():
            yield from leaves(spec[k], v)
    elif isinstance(shard, (tuple, list)):
        for a, s in zip(spec, shard):
            yield from leaves(a, s)
    else:
        for f in ("params", "m", "v", "step", "dyn_counter"):
            yield from leaves(getattr(spec, f), getattr(shard, f))

for name in configs.ARCHS:
    for shape in KINDS:
        for fsdp in (True, False):
            cell = SHAPES_BY_NAME[shape]
            fn, args, shards, _ = build_cell(configs.get(name), cell, mesh,
                                             fsdp=fsdp)
            out[f"{{name}}|{{shape}}|{{fsdp}}"] = _port_flat(args, shards,
                                                            cell.kind)
            if fsdp:
                for spec, shard in leaves(args, shards):
                    d = _zeros(spec, shard, "meta")
                    assert d.placements == shard.placements
                    assert tuple(d.shape) == tuple(spec.shape)
                    built += 1
print(json.dumps({{"cells": out, "built": built,
                  "mesh": list(mesh.mesh.shape)}}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_specs_equal_the_references(multi):
    """make_production_mesh in a fake world of 256 / 512 ranks: every
    cell's specs equal the reference's `spec_for` / `zero_spec` on a
    duck-typed mesh of the same shape, and each leaf's placements build a
    meta DTensor."""
    code = PRODUCTION.format(
        helpers="\n".join(inspect.getsource(f) for f in (_spec_json,
                                                         _port_flat)),
        kinds=KINDS, multi=multi)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=150,
                         env={"PYTHONPATH": f"{ROOT}/src",
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    shape = (2, 32, 8) if multi else (32, 8)
    axes = ("pod", "data", "model") if multi else ("data", "model")
    assert tuple(got["mesh"]) == shape
    mesh = FakeMesh(shape, axes)
    for name in configs.ARCHS:
        cfg, rcfg = configs.get(name), rconfigs.get(name)
        for kind in KINDS:
            for fsdp in (True, False):
                want = _ref_expected(cfg, rcfg, SHAPES_BY_NAME[kind], mesh,
                                     fsdp)
                have = {k: tuple(v) for k, v in
                        got["cells"][f"{name}|{kind}|{fsdp}"].items()}
                assert have == {k: tuple(v) for k, v in want.items()}, (
                    name, kind, fsdp)
    assert got["built"] > 5_000


# the 18 forms of the reference's `_apply_one`, the four that take a
# number at one value each, and a composition
VARIANTS = ["base", "no_remat", "attn_gather", "donate", "no_fsdp",
            "bf16_params", "bf16_opt", "mb2", "qc256", "kc512", "xent1024",
            "no_sp", "sp_data", "kv_seq_replicated", "kv_seq_model",
            "batch_model", "embed_shard", "expert_data",
            "no_fsdp+bf16_params+mb2"]


def _fields(cfg) -> dict:
    """A config's fields, dtypes by name (torch's and numpy's alike)."""
    return {k: (_dt(v) if isinstance(v, torch.dtype) else np.dtype(v).name)
            if "dtype" in k else v for k, v in vars(cfg).items()}


@pytest.mark.parametrize("variant", VARIANTS)
def test_apply_variant_equals_the_references(variant):
    name = "phi4_mini_3_8b"
    shape = SHAPES_BY_NAME["train_4k"]
    cfg, rules, opts = variants.apply_variant(configs.get(name), shape,
                                              variant)
    rcfg, rrules, ropts = rvariants.apply_variant(
        rconfigs.get(name), next(s for s in R_SHAPES
                                 if s.name == "train_4k"), variant)
    rf = _fields(rcfg)
    assert {k: v for k, v in _fields(cfg).items() if k in rf} == {
        k: v for k, v in rf.items() if k in _fields(cfg)}
    assert rules == T.RuleSet(rrules.rules)
    assert opts == ropts


def test_apply_variant_refuses_an_unknown_form():
    with pytest.raises(KeyError, match="unknown variant"):
        variants.apply_variant(configs.get("phi4_mini_3_8b"),
                               SHAPES_BY_NAME["train_4k"], "base+fast")
    assert len(VARIANTS) == 19


def test_cell_tables_and_argument_bytes():
    """INPUT_AXES / CACHE_AXES are the reference's; the argument bytes a
    device holds on the (32, 8) mesh fall with FSDP, and phi4-mini's
    train cell holds its state's bytes over the data x model shards."""
    assert INPUT_AXES == R_INPUT_AXES and CACHE_AXES == R_CACHE_AXES
    mesh = FakeMesh((32, 8), ("data", "model"))
    cell = SHAPES_BY_NAME["train_4k"]
    cfg = configs.get("phi4_mini_3_8b")
    _, args, shards, _ = build_cell(cfg, cell, mesh)
    _, _, tp, _ = build_cell(cfg, cell, mesh, fsdp=False)
    fsdp, tp_only = argument_bytes(args, shards), argument_bytes(args, tp)
    n = sum(p.numel() for p in args[0].params.values())
    batch = 2 * 256 * 4096 * 4 // 256       # tokens, labels: data x model
    # FSDP: params and moments sharded over all 256 cards but the leaves
    # no rule splits and the few the data axis does not divide
    assert 12 * n / 256 < fsdp - batch < 12 * n / 256 * 1.05
    assert tp_only > fsdp and fsdp < HBM_BYTES


def test_constraints_change_nothing_without_a_mesh():
    """The models' constraints and DTensor helpers return plain tensors
    unchanged, inside `activation_sharding` too: a loss and a decode step
    are bit-identical in and out of the context."""
    from repro_torch.launch.train import PRESETS

    cfg = PRESETS["lm2m"].replace(attn_gather=True)
    model = build(cfg, device="cpu", seed=1)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
             for k in ("tokens", "labels")}
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1)))
    runs = []
    for ctx in (False, True):
        cache = model.init_cache(2, 64)
        with (T.activation_sharding(FakeMesh((2, 2), ("data", "model")))
              if ctx else _null()):
            loss = model.loss(batch)
            logits = model.decode_step(tok, cache, 3)
        runs.append((loss.detach(), logits, cache["b0"]["attn"]["k"]))
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_cell_step_refuses_foreign_params():
    from repro_torch.launch.train import PRESETS

    cfg = PRESETS["lm2m"]
    fn, args, _, _ = build_cell(cfg, ShapeSpec("p", 64, 2, "prefill"),
                                FakeMesh((1, 1), ("data", "model")))
    other = dict(args[0])
    other["embed"] = torch.empty_like(other["embed"])
    with pytest.raises(ValueError, match="not this cell's model"):
        fn(other, args[1])
