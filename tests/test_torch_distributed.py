"""The multi-device runtime against the reference, on the CPU.

The compressed-gradient DP step, GPipe and elastic re-meshing run in
worlds of gloo ranks on the CPU (`torch_world.run_world`: a subprocess
per world, a free localhost port, a hard timeout), while the reference's
oracle runs in a JAX process of forced host devices with its calls inside
`jax.set_mesh` (`torch_world.start_jax`).  Inputs come from numpy seeds
and pass between the processes as .npz files.  The quantizer, the wire
gate and the one-rank ledger booking run in this process.

Tolerances: the DP step's parameters and loss within 1e-5 of the
reference's (autograd and `jax.grad` sum in different orders), its
counter trajectory exact; GPipe within 1e-5 of the reference and of the
layers applied in sequence; the quantizer, the grids and every shard
exact."""

import datetime
import re
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_world import finish, run_world, start_jax

from repro.bandwidth.adapters import int8_wire_bytes as r_int8_bytes
from repro.bandwidth.adapters import tree_wire_bytes as r_tree_bytes
from repro.optim import grad_compress as rgc
from repro_torch.bandwidth import Ledger
from repro_torch.bandwidth.adapters import int8_wire_bytes, tree_wire_bytes
from repro_torch.compression import gate
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.launch.train import PRESETS
from repro_torch.models import init_lm
from repro_torch.optim import grad_compress as gc
from repro_torch.runtime.elastic import shrink_mesh

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _flat(tree, prefix=""):
    """Nested dict -> {"a/b/c": numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *heads, leaf = key.split("/")
        t = tree
        for h in heads:
            t = t.setdefault(h, {})
        t[leaf] = v
    return tree


# the oracle's helpers, prepended to each JAX body
JAX_HEAD = """
import json
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

def nest(flat):
    tree = {}
    for key, v in flat.items():
        *heads, leaf = key.split("/")
        t = tree
        for h in heads:
            t = t.setdefault(h, {})
        t[leaf] = jnp.asarray(v)
    return tree

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out
"""


# ---------------------------------------------- quantizer and gate (here)

def test_compress_tree_is_bit_exact_with_the_reference():
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((64, 48)).astype(np.float32) * 3e-3,
             "b": rng.standard_normal((40,)).astype(np.float32),
             "c": np.zeros((7, 5), np.float32)}
    err = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-4
           for k, v in grads.items()}
    for k, g in grads.items():
        rq, rs = rgc.quantize_int8(jnp.asarray(g + err[k]))
        q, s = gc.quantize_int8(torch.from_numpy(g + err[k]))
        assert np.array_equal(q.numpy(), np.asarray(rq)), k
        assert s.item() == float(rs), k
        assert np.array_equal(gc.dequantize(q, s).numpy(),
                              np.asarray(rgc.dequantize(rq, rs))), k
    rdq, rerr, rrel = rgc.compress_tree(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in err.items()})
    dq, new_err, rel = gc.compress_tree(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in err.items()})
    for k in grads:
        assert np.array_equal(dq[k].numpy(), np.asarray(rdq[k])), k
        assert np.array_equal(new_err[k].numpy(), np.asarray(rerr[k])), k
    np.testing.assert_allclose(rel.item(), float(rrel), rtol=1e-6)


def test_gate_update_routes_through_the_wire_gate():
    for c0 in (gate.ENABLE_THRESHOLD + 10, 3, gate.COUNTER_MAX - 5):
        for rel in (0.01, 0.5):
            want = rgc.gate_update(jnp.int32(c0), jnp.float32(rel))
            got = gc.gate_update(torch.tensor(c0, dtype=torch.int32),
                                 torch.tensor(rel, dtype=torch.float32))
            assert got.dtype == torch.int32 and int(got) == int(want)
            assert int(gc.gate_update(np.int32(c0), np.float32(rel))) == \
                int(want)
    assert (gate.WIRE_BENEFIT_SCALE, gate.WIRE_COST_OVER_BUDGET) == (16, 64)
    assert gc.gate_enabled(gate.ENABLE_THRESHOLD)
    assert not gc.gate_enabled(gate.ENABLE_THRESHOLD - 1)


def test_wire_bytes_match_the_reference():
    tree = {"a": np.zeros((16, 16), np.float32),
            "b": np.zeros((8,), np.float16)}
    assert tree_wire_bytes(tree) == r_tree_bytes(tree) == 16 * 16 * 4 + 16
    assert int8_wire_bytes(tree) == r_int8_bytes(tree) == 16 * 16 + 4 + 8 + 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Quad(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones((8, 8)))

    def loss(self, batch):
        return torch.mean((self.w - torch.as_tensor(batch)) ** 2)


def test_dp_step_books_wire_bytes_per_policy():
    """The reference's one-device ledger test (tests/test_bandwidth.py),
    in this process over a one-rank gloo world."""
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=30))
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        shapes = {"w": np.ones((8, 8), np.float32)}
        raw = tree_wire_bytes(shapes)
        for policy, want_comp in (("static", int8_wire_bytes(shapes)),
                                  ("off", raw),
                                  ("auto", int8_wire_bytes(shapes))):
            model = _Quad()
            params = dict(model.named_parameters())
            err = {k: torch.zeros_like(p) for k, p in params.items()}
            led = Ledger()
            step = gc.make_dp_compressed_step(model, mesh, policy=policy,
                                              ledger=led)
            counter = torch.tensor(gate.COUNTER_INIT, dtype=torch.int32)
            _, _, counter, loss = step(params, err, counter,
                                       np.zeros((1, 8, 8), np.float32))
            t = led.total("write", consumer="grad")
            assert t["raw_bytes"] == raw
            assert t["compressed_bytes"] == want_comp
            assert np.isfinite(float(loss))
        with pytest.raises(ValueError, match="policy"):
            gc.make_dp_compressed_step(_Quad(), mesh, policy="sometimes")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ the DP step, four ranks

DP_STEPS, DP_LR = 3, 5e-3
DP_POLICIES = ("off", "static", "dynamic")
# below the threshold: two plain steps, then the gate turns on
DP_COUNTER0 = gate.ENABLE_THRESHOLD - 20


def test_dp_compressed_step_matches_the_reference_at_four_ranks(tmp_path):
    cfg = PRESETS["lm2m"]
    gen = torch.Generator().manual_seed(0)
    params = init_lm(cfg, gen, "cpu")
    np.savez(tmp_path / "params.npz",
             **{k: v.numpy() for k, v in params.items()})
    np.savez(tmp_path / "ref_params.npz",
             **_flat(params_to_jax(params, 1)))
    rng = np.random.default_rng(11)
    np.savez(tmp_path / "batch.npz",
             tokens=rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32),
             labels=rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32))
    oracle = start_jax(JAX_HEAD + f"""
from repro.launch.train import PRESETS
from repro.models import build
from repro.optim import grad_compress as gc
mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))
model = build(PRESETS["lm2m"])
batch = {{k: jnp.asarray(v) for k, v in np.load(OUT + "/batch.npz").items()}}
res = {{}}
with jax.set_mesh(mesh):
    for policy in {DP_POLICIES!r}:
        params = nest(dict(np.load(OUT + "/ref_params.npz")))
        err = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        counter = jnp.int32({DP_COUNTER0})
        step = gc.make_dp_compressed_step(model, mesh, lr={DP_LR},
                                          policy=policy)
        losses, counters = [], []
        for _ in range({DP_STEPS}):
            params, err, counter, loss = step(params, err, counter, batch)
            losses.append(float(loss))
            counters.append(int(counter))
        res[policy] = {{"loss": losses, "counter": counters}}
        np.savez(OUT + f"/ref_{{policy}}.npz", **flat(params))
json.dump(res, open(OUT + "/ref.json", "w"))
""", tmp_path)
    run_world(f"""
import json
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch.train import PRESETS
from repro_torch.models import build
from repro_torch.optim import grad_compress as gc
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
batch = dict(np.load(OUT + "/batch.npz"))
res = {{}}
for policy in {DP_POLICIES!r}:
    state = {{k: torch.from_numpy(v)
              for k, v in np.load(OUT + "/params.npz").items()}}
    model = build(PRESETS["lm2m"], device="cpu", params=state)
    params = dict(model.named_parameters())
    err = {{k: torch.zeros_like(p) for k, p in params.items()}}
    counter = torch.tensor({DP_COUNTER0}, dtype=torch.int32)
    step = gc.make_dp_compressed_step(model, mesh, lr={DP_LR}, policy=policy)
    losses, counters = [], []
    for _ in range({DP_STEPS}):
        params, err, counter, loss = step(params, err, counter, batch)
        losses.append(float(loss))
        counters.append(int(counter))
    res[policy] = {{"loss": losses, "counter": counters}}
    if RANK == 0:
        np.savez(OUT + f"/port_{{policy}}.npz",
                 **{{k: p.detach().numpy() for k, p in params.items()}})
if RANK == 0:
    json.dump(res, open(OUT + "/port.json", "w"))
""", 4, tmp_path)
    finish(oracle)
    import json
    ref = json.loads((tmp_path / "ref.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    for policy in DP_POLICIES:
        assert port[policy]["counter"] == ref[policy]["counter"], policy
        np.testing.assert_allclose(port[policy]["loss"], ref[policy]["loss"],
                                   **TOL)
        want = params_from_jax(_nest(dict(np.load(
            tmp_path / f"ref_{policy}.npz"))))
        got = np.load(tmp_path / f"port_{policy}.npz")
        assert set(got.files) == set(want)
        for k in got.files:
            np.testing.assert_allclose(got[k], want[k].numpy(), **TOL,
                                       err_msg=f"{policy} {k}")
    # the dynamic gate was off for two steps, then on: each step's benefit
    # is int(16 * saving), saving = 0.75 less 4 bytes a leaf
    assert ref["dynamic"]["counter"] == [DP_COUNTER0 + 11 * i
                                         for i in range(1, DP_STEPS + 1)]
    assert ref["dynamic"]["counter"][1] >= gate.ENABLE_THRESHOLD
    assert ref["off"]["counter"] == [DP_COUNTER0] * DP_STEPS


# ------------------------------------------------------ GPipe, four ranks

GP_L, GP_D, GP_M, GP_MB, GP_S = 8, 32, 4, 2, 8


def test_gpipe_matches_sequential_and_the_reference_at_four_stages(
        tmp_path):
    rng = np.random.default_rng(3)
    np.savez(tmp_path / "gp.npz",
             w=(rng.standard_normal((GP_L, GP_D, GP_D)) * 0.2).astype(
                 np.float32),
             x=rng.standard_normal((GP_M, GP_MB, GP_S, GP_D)).astype(
                 np.float32))
    oracle = start_jax(JAX_HEAD + """
from repro.runtime.pipeline import gpipe_apply, split_stages
mesh = Mesh(np.asarray(jax.devices()[:4]), ("stage",))
d = np.load(OUT + "/gp.npz")
ws, x = jnp.asarray(d["w"]), jnp.asarray(d["x"])

def stage_fn(w_stage, x):
    for i in range(w_stage.shape[0]):
        x = jnp.tanh(x @ w_stage[i])
    return x

with jax.set_mesh(mesh):
    out = gpipe_apply(split_stages(ws, 4), x, mesh=mesh, stage_fn=stage_fn)
np.savez(OUT + "/ref_gp.npz", out=np.asarray(out))
""", tmp_path)
    run_world("""
import numpy as np
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.runtime.pipeline import gpipe_apply, split_stages
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("stage",))
d = np.load(OUT + "/gp.npz")
w = torch.from_numpy(d["w"]).requires_grad_()
x = torch.from_numpy(d["x"])

def stage_fn(w_stage, x):
    for i in range(w_stage.shape[0]):
        x = torch.tanh(x @ w_stage[i])
    return x

out = gpipe_apply(split_stages(w, WORLD), x, mesh=mesh, stage_fn=stage_fn)
(out ** 2).sum().backward()
grad = w.grad.clone()
dist.all_reduce(grad)          # each stage holds its own layers' gradient
np.savez(OUT + f"/port_gp{RANK}.npz", out=out.detach().numpy(),
         grad=grad.numpy(), own=w.grad.numpy())
""", 4, tmp_path)
    finish(oracle)
    w = torch.from_numpy(np.load(tmp_path / "gp.npz")["w"]).requires_grad_()
    x = torch.from_numpy(np.load(tmp_path / "gp.npz")["x"])
    outs = []
    for m in range(GP_M):                # the layers in sequence
        y = x[m]
        for i in range(GP_L):
            y = torch.tanh(y @ w[i])
        outs.append(y)
    seq = torch.stack(outs)
    (seq ** 2).sum().backward()
    ref = np.load(tmp_path / "ref_gp.npz")["out"]
    per = GP_L // 4
    for rank in range(4):
        got = np.load(tmp_path / f"port_gp{rank}.npz")
        np.testing.assert_allclose(got["out"], seq.detach().numpy(), **TOL)
        np.testing.assert_allclose(got["out"], ref, **TOL)
        np.testing.assert_allclose(got["grad"], w.grad.numpy(), **TOL)
        # a stage's gradient lands on its own layers only
        own = np.zeros_like(got["own"])
        own[rank * per:(rank + 1) * per] = got["own"][
            rank * per:(rank + 1) * per]
        assert np.array_equal(got["own"], own)
        assert np.abs(own).sum() > 0


# ------------------------------------------------------ elastic re-meshing

SHRINK_CASES = [(4, set(), None), (4, {3}, None), (4, {1}, 2),
                (4, 2, None), (8, {5}, 4), (8, {0, 7}, 2), (8, {2}, 2),
                (8, 3, 4), (8, set(), 8)]


def test_shrink_mesh_grids_match_the_reference(tmp_path):
    oracle = start_jax(JAX_HEAD + f"""
from repro.runtime.elastic import shrink_mesh
out = []
for n, failed, model in {[(n, sorted(f) if isinstance(f, set) else f, m)
                          for n, f, m in SHRINK_CASES]!r}:
    failed = set(failed) if isinstance(failed, list) else failed
    mesh = shrink_mesh(failed, model_axis=model, devices=jax.devices()[:n])
    out.append({{"ids": np.vectorize(lambda d: d.id)(mesh.devices).tolist(),
                 "axes": list(mesh.axis_names)}})
json.dump(out, open(OUT + "/grids.json", "w"))
""", tmp_path, devices=8)
    finish(oracle)
    import json
    want = json.loads((tmp_path / "grids.json").read_text())
    for (n, failed, model), ref in zip(SHRINK_CASES, want, strict=True):
        grid = shrink_mesh(failed, model_axis=model, ranks=range(n))
        assert grid.ranks.tolist() == ref["ids"], (n, failed, model)
        assert list(grid.axis_names) == ref["axes"]
        assert grid.shape == dict(zip(ref["axes"],
                                      np.shape(ref["ids"]), strict=True))
    with pytest.raises(ValueError, match="no ranks survive"):
        shrink_mesh(4, ranks=range(4))


def _coord_key(name: str, coord) -> str:
    return f"{name}@{','.join(map(str, coord))}"


def test_reshard_tree_places_each_shard_as_the_reference(tmp_path):
    """A restored lm2m state placed on a 2 x 2 (data, model) mesh of four
    ranks, and on the grid `shrink_mesh({3})` leaves for the three that
    re-form their world: every rank's local shard is the reference's
    shard at the same mesh coordinate."""
    cfg = PRESETS["lm2m"]
    params = init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
    np.savez(tmp_path / "params.npz",
             **{k: v.numpy() for k, v in params.items()})
    np.savez(tmp_path / "ref_params.npz", **_flat(params_to_jax(params, 1)))
    oracle = start_jax(JAX_HEAD + """
from repro.launch.train import PRESETS
from repro.models import build
from repro.runtime.elastic import reshard_tree, shrink_mesh
_, axes = build(PRESETS["lm2m"]).abstract_params()
tree = nest(dict(np.load(OUT + "/ref_params.npz")))
meshes = {"2x2": Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                      ("data", "model")),
          "shrunk": shrink_mesh({3}, devices=jax.devices()[:4])}
for tag, mesh in meshes.items():
    out = {}
    placed = reshard_tree(tree, axes, mesh)
    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
                continue
            for sh in v.addressable_shards:
                coord = np.argwhere(mesh.devices == sh.device)[0]
                out[f"{prefix}{k}@" + ",".join(map(str, coord))] = \\
                    np.asarray(sh.data)
    walk(placed)
    np.savez(OUT + f"/ref_{tag}.npz", **out)
""", tmp_path)
    body = """
import numpy as np
from repro_torch.launch.train import PRESETS
from repro_torch.models import param_axes
from repro_torch.runtime.elastic import reshard_tree, shrink_mesh
tree = {k: torch.from_numpy(v)
        for k, v in np.load(OUT + "/params.npz").items()}
TAG_AND_MESH
coord = mesh.get_coordinate()
placed = reshard_tree(tree, param_axes(PRESETS["lm2m"]), mesh)
np.savez(OUT + f"/port_{TAG}{RANK}.npz",
         **{f"{k}@" + ",".join(map(str, coord)): v.to_local().numpy()
            for k, v in placed.items()})
"""
    run_world(body.replace("TAG_AND_MESH", """
from torch.distributed.device_mesh import init_device_mesh
TAG = "2x2"
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
"""), 4, tmp_path)
    run_world(body.replace("TAG_AND_MESH", """
TAG = "shrunk"
grid = shrink_mesh({3}, ranks=range(4))
mesh = grid.build("cpu")
"""), 3, tmp_path)
    finish(oracle)
    per = 1                             # lm2m: one layer a super-block
    for tag, world in (("2x2", 4), ("shrunk", 3)):
        ref = np.load(tmp_path / f"ref_{tag}.npz")
        sharded = 0
        for rank in range(world):
            got = np.load(tmp_path / f"port_{tag}{rank}.npz")
            assert len(got.files) == len(params)
            for key in got.files:
                name, coord = key.split("@")
                m = re.fullmatch(r"blocks\.(\d+)\.(.*)", name)
                if m:
                    s, j = divmod(int(m[1]), per)
                    want = ref[f"blocks/b{j}/{m[2].replace('.', '/')}"
                               f"@{coord}"][s]
                else:
                    want = ref[f"{name.replace('.', '/')}@{coord}"]
                assert np.array_equal(got[key], want), (tag, key)
                sharded += got[key].shape != params[name].shape
        assert (sharded > 0) == (tag == "2x2")


# ------------------------------------------------- the model cell on a mesh
#
# Tolerance of the sharded steps against the one-rank unsharded step:
# 1e-5 absolute and relative on the losses, on every parameter after each
# step and on the written cache rows (the mesh reorders float32 sums: the
# gradient's reduce-scatters, the norm's per-shard sums, the decode's
# combine of the per-shard softmax states); the decode's next tokens
# equal.

CELL_TOL = dict(atol=1e-5, rtol=1e-5)
CELL_STEPS, CELL_B, CELL_S, CELL_SEED = 3, 4, 64, 3


def test_collective_bytes_follow_the_references_rule(tmp_path):
    """One all-gather, one reduce-scatter and one all-reduce of known
    DTensors (f32, 8 x 4 over a 4-rank mesh), recorded by `analyze_step`,
    count what the reference's `collective_bytes` counts for an HLO text
    of the same three ops."""
    from repro.launch.hlo_analysis import collective_bytes

    run_world("""
import json
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch.hlo_analysis import analyze_step
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
x = DTensor.from_local(torch.ones(2, 4), mesh, (Shard(0),))
p = DTensor.from_local(torch.ones(8, 4), mesh, (Partial(),))

def step(x, p):
    return (x.redistribute(mesh, (Replicate(),)),
            p.redistribute(mesh, (Shard(0),)),
            p.redistribute(mesh, (Replicate(),)))

r = analyze_step(step, x, p)
ag, rs, ar = r["out"]
assert torch.equal(ag.to_local(), torch.ones(8, 4))
assert torch.equal(rs.to_local(), torch.full((2, 4), 4.0))
assert torch.equal(ar.to_local(), torch.full((8, 4), 4.0))
if RANK == 0:
    json.dump({"coll": r["collectives"], "flops": r["flops"],
               "held": r["argument_bytes"]}, open(OUT + "/r.json", "w"))
""", 4, tmp_path)
    import json
    got = json.loads((tmp_path / "r.json").read_text())
    hlo = "\n".join([
        "%ag = f32[8,4]{1,0} all-gather(f32[2,4]{1,0} %x), "
        "replica_groups=[1,4]<=[4], dimensions={0}",
        "%rs = f32[2,4]{1,0} reduce-scatter(f32[8,4]{1,0} %p), "
        "replica_groups=[1,4]<=[4], dimensions={0}, to_apply=%add",
        "%ar = f32[8,4]{1,0} all-reduce(f32[8,4]{1,0} %p), "
        "replica_groups=[1,4]<=[4], to_apply=%add"])
    want = collective_bytes(hlo)
    assert got["coll"] == want
    assert want["total_ops"] == 3 and want["total_bytes"] == 3 * 128
    assert got["flops"] == 0 and got["held"] == (2 * 4 + 8 * 4) * 4


CELL_HEAD = f"""
import json
import numpy as np
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, place_cell
from repro_torch.launch.train import PRESETS
from repro_torch.models import ShapeSpec
cfg = PRESETS["lm2m"]
mesh = make_host_mesh(2, device_type="cpu")
B, S, SEED = {CELL_B}, {CELL_S}, {CELL_SEED}
"""


def _unsharded_model():
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import build

    return build(PRESETS["lm2m"], device="cpu", seed=CELL_SEED)


@pytest.mark.parametrize("fsdp", [True, False])
def test_sharded_train_cell_matches_one_rank(tmp_path, fsdp):
    """lm2m's train cell on a 2 x 2 mesh of 4 gloo ranks, built by
    `build_cell` and placed from the seed: CELL_STEPS steps equal the
    one-rank unsharded steps within CELL_TOL, parameters and moments
    placed as the cell says (FSDP / ZeRO-1, or tensor parallel only)."""
    from repro_torch.optim.adamw import adamw_init, make_train_step

    rng = np.random.default_rng(17)
    batch = {k: rng.integers(0, 2048, (CELL_B, CELL_S)).astype(np.int32)
             for k in ("tokens", "labels")}
    np.savez(tmp_path / "batch.npz", **batch)
    run_world(CELL_HEAD + f"""
fn, specs, shards, _ = build_cell(cfg, ShapeSpec("t", S, B, "train"), mesh,
                                  fsdp={fsdp})
batch = dict(np.load(OUT + "/batch.npz"))
state, pb = place_cell(fn, specs, shards, (batch,), seed=SEED, device="cpu")
for k, p in state.params.items():
    assert p.placements == shards[0].params[k].placements, k
    assert state.m[k].placements == shards[0].m[k].placements, k
losses = []
for _ in range({CELL_STEPS}):
    state, m = fn(state, pb)
    losses.append([float(m["loss"]), float(m["gnorm"])])
full = {{k: p.detach().full_tensor().numpy()
        for k, p in state.params.items()}}
if RANK == 0:
    np.savez(OUT + "/params.npz", **full)
    json.dump(losses, open(OUT + "/losses.json", "w"))
""", 4, tmp_path)
    model = _unsharded_model()
    state = adamw_init(model)
    step = make_train_step(model)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(CELL_STEPS):
        state, m = step(state, tb)
        losses.append([float(m["loss"]), float(m["gnorm"])])
    import json
    got = json.loads((tmp_path / "losses.json").read_text())
    np.testing.assert_allclose(got, losses, **CELL_TOL)
    placed = np.load(tmp_path / "params.npz")
    assert set(placed.files) == set(state.params)
    for k, p in state.params.items():
        np.testing.assert_allclose(placed[k], p.detach().numpy(),
                                   **CELL_TOL, err_msg=k)
    assert losses[-1][0] < losses[0][0]


def test_sharded_decode_cell_matches_one_rank(tmp_path):
    """lm2m's decode cell on 2 x 2 ranks: the cache (B = 4, T = 128)
    splits its batch over "data" and its sequence over "model", a random
    prefix in it; two steps at positions 100 and 101 (the written rows
    on the rank that owns them, the attention combined over the sequence
    shards) give the unsharded step's next tokens and cache rows."""
    from repro_torch.launch.steps import make_serve_step

    rng = np.random.default_rng(19)
    kv = {k: rng.standard_normal((2, CELL_B, 128, 4, 32)).astype(np.float32)
          for k in ("k", "v")}
    tok = rng.integers(0, 2048, (CELL_B, 1)).astype(np.int32)
    np.savez(tmp_path / "dec.npz", tok=tok, **kv)
    run_world(CELL_HEAD + """
from torch.distributed.tensor import Shard
fn, specs, shards, _ = build_cell(cfg, ShapeSpec("d", 128, B, "decode"),
                                  mesh)
d = dict(np.load(OUT + "/dec.npz"))
cache = {"b0": {"attn": {"k": d["k"], "v": d["v"]}}}
params, tok, cache, index = place_cell(fn, specs, shards,
                                       (d["tok"], cache, 100), seed=SEED,
                                       device="cpu")
assert cache["b0"]["attn"]["k"].placements == (Shard(1), Shard(2))
toks = []
for i in (100, 101):
    tok, cache = fn(params, tok, cache, torch.tensor(i, dtype=torch.int32))
    toks.append(tok.full_tensor().flatten().tolist())
full = {k: v.full_tensor().numpy() for k, v in cache["b0"]["attn"].items()}
if RANK == 0:
    np.savez(OUT + "/cache.npz", **full)
    json.dump(toks, open(OUT + "/toks.json", "w"))
""", 4, tmp_path)
    model = _unsharded_model()
    step = make_serve_step(model)
    cache = {"b0": {"attn": {k: torch.from_numpy(v.copy())
                             for k, v in kv.items()}}}
    t, toks = torch.from_numpy(tok), []
    for i in (100, 101):
        t, cache = step(t, cache, i)
        toks.append(t.flatten().tolist())
    import json
    assert json.loads((tmp_path / "toks.json").read_text()) == toks
    got = np.load(tmp_path / "cache.npz")
    for k in ("k", "v"):
        want = cache["b0"]["attn"][k].numpy()
        np.testing.assert_allclose(got[k][:, :, 100:102], want[:, :, 100:102],
                                   **CELL_TOL)
        assert np.array_equal(np.delete(got[k], [100, 101], axis=2),
                              np.delete(want, [100, 101], axis=2))
        assert not np.array_equal(want[:, :, 100:102], kv[k][:, :, 100:102])


def test_sharded_prefill_cell_matches_one_rank(tmp_path):
    """lm2m's prefill cell on 2 x 2 ranks (batch over "data", the
    activations' sequence over "model"), placed from full tensors (the
    reference's init for seed 5): the last position's logits equal the
    unsharded prefill step's within CELL_TOL."""
    from repro_torch.launch.train import PRESETS
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build, init_lm_reference

    rng = np.random.default_rng(23)
    tokens = rng.integers(0, 2048, (CELL_B, CELL_S)).astype(np.int32)
    np.save(tmp_path / "tokens.npy", tokens)
    params = init_lm_reference(PRESETS["lm2m"], 5, "cpu")
    np.savez(tmp_path / "params.npz",
             **{k: v.numpy() for k, v in params.items()})
    run_world(CELL_HEAD + """
fn, specs, shards, _ = build_cell(cfg, ShapeSpec("p", S, B, "prefill"), mesh)
tokens = np.load(OUT + "/tokens.npy")
full = {k: torch.from_numpy(v)
        for k, v in np.load(OUT + "/params.npz").items()}
params, batch = place_cell(fn, specs, shards, ({"tokens": tokens},),
                           params=full, device="cpu")
assert not full                 # each full tensor handed over and let go
logits = fn(params, batch).full_tensor()
if RANK == 0:
    np.save(OUT + "/logits.npy", logits.numpy())
""", 4, tmp_path)
    model = build(PRESETS["lm2m"], device="cpu", params=params)
    want = make_prefill_step(model)({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(np.load(tmp_path / "logits.npy"),
                               want.numpy(), **CELL_TOL)


def test_mini_cell_counts_flops_and_collectives(tmp_path):
    """The reference's mini dry run, as the port does it: olmoe at smoke
    size on a (4, 2) mesh of 8 gloo ranks, a ShapeSpec("mini", 128, 8,
    "train") cell under `analyze_step`: flops above 0, at least one
    collective, and the loss of the unsharded step within CELL_TOL."""
    run_world("""
import json
import numpy as np
from repro_torch import configs
from repro_torch.launch.hlo_analysis import analyze_step, argument_bytes
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, place_cell
from repro_torch.models import ShapeSpec, smoke_config
cfg = smoke_config(configs.get("olmoe_1b_7b"))
mesh = make_host_mesh(2, device_type="cpu")
fn, specs, shards, _ = build_cell(cfg, ShapeSpec("mini", 128, 8, "train"),
                                  mesh)
rng = np.random.default_rng(0)
batch = {k: rng.integers(0, cfg.vocab, (8, 128)).astype(np.int32)
         for k in ("tokens", "labels")}
args = place_cell(fn, specs, shards, (batch,), seed=0, device="cpu")
r = analyze_step(fn, *args)
assert r["argument_bytes"] == argument_bytes(specs, shards)
if RANK == 0:
    np.savez(OUT + "/batch.npz", **batch)
    json.dump({"flops": r["flops"], "coll": r["collectives"],
               "loss": float(r["out"][1]["loss"])},
              open(OUT + "/mini.json", "w"))
""", 8, tmp_path, timeout=85)
    import json

    from repro_torch import configs
    from repro_torch.models import build, smoke_config
    from repro_torch.optim.adamw import adamw_init, make_train_step

    got = json.loads((tmp_path / "mini.json").read_text())
    assert got["flops"] > 0
    assert got["coll"]["total_ops"] > 0 and got["coll"]["total_bytes"] > 0
    cfg = smoke_config(configs.get("olmoe_1b_7b"))
    model = build(cfg, device="cpu", seed=0)
    batch = {k: torch.from_numpy(v)
             for k, v in np.load(tmp_path / "batch.npz").items()}
    _, m = make_train_step(model)(adamw_init(model), batch)
    np.testing.assert_allclose(got["loss"], float(m["loss"]), **CELL_TOL)


FAMILY_CELLS = {"moe": "olmoe_1b_7b", "ssm": "mamba2_130m",
                "hybrid": "zamba2_2_7b", "vlm": "llama_3_2_vision_90b",
                "encdec": "whisper_base"}


@pytest.mark.parametrize("family", list(FAMILY_CELLS))
def test_every_family_runs_its_cells_on_a_mesh(tmp_path, family):
    """Each family's train and decode cells at smoke size on 2 x 2 gloo
    ranks (the MoE's experts and the SSM's heads split over the ranks, the
    vlm's image embeddings, whisper's frames and cross K/V): the train
    loss within CELL_TOL of the unsharded step's, the decode's next tokens
    equal."""
    from repro_torch import configs
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build, smoke_config
    from repro_torch.optim.adamw import adamw_init, make_train_step

    name = FAMILY_CELLS[family]
    cfg = smoke_config(configs.get(name))
    rng = np.random.default_rng(29)
    data = {k: rng.integers(0, cfg.vocab, (CELL_B, CELL_S)).astype(np.int32)
            for k in ("tokens", "labels")}
    if family == "vlm":
        data["image_embeds"] = rng.standard_normal(
            (CELL_B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if family == "encdec":
        data["frames"] = rng.standard_normal(
            (CELL_B, CELL_S, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab, (CELL_B, 1)).astype(np.int32)
    np.savez(tmp_path / "in.npz", tok=tok, **data)
    run_world(f"""
import json
import numpy as np
from repro_torch import configs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, place_cell
from repro_torch.models import ShapeSpec, smoke_config
cfg = smoke_config(configs.get({name!r}))
mesh = make_host_mesh(2, device_type="cpu")
d = dict(np.load(OUT + "/in.npz"))
tok = d.pop("tok")
fn, specs, shards, _ = build_cell(cfg, ShapeSpec("t", {CELL_S}, {CELL_B},
                                                 "train"), mesh)
_, m = fn(*place_cell(fn, specs, shards, (d,), seed=1, device="cpu"))
fn, specs, shards, _ = build_cell(cfg, ShapeSpec("d", {CELL_S}, {CELL_B},
                                                 "decode"), mesh)
vals = (tok, None, 5) + ((d["image_embeds"],) if {family!r} == "vlm"
                         else ())
nxt, _ = fn(*place_cell(fn, specs, shards, vals, seed=1, device="cpu"))
nxt = nxt.full_tensor().flatten().tolist()
if RANK == 0:
    json.dump({{"loss": float(m["loss"]), "next": nxt}},
              open(OUT + "/r.json", "w"))
""", 4, tmp_path)
    import json
    got = json.loads((tmp_path / "r.json").read_text())
    model = build(cfg, device="cpu", seed=1)
    _, m = make_train_step(model)(adamw_init(model), {
        k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(got["loss"], float(m["loss"]), **CELL_TOL)
    kw = ({"image_embeds": torch.from_numpy(data["image_embeds"])}
          if family == "vlm" else {})
    nxt, _ = make_serve_step(model)(torch.from_numpy(tok),
                                    model.init_cache(CELL_B, CELL_S), 5,
                                    **kw)
    assert got["next"] == nxt.flatten().tolist()


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_maverick_400b_a17b"])
def test_moe_cell_runs_each_ranks_experts_on_their_rows(tmp_path, arch):
    """The MoE on a 2 x 2 mesh keeps its experts sharded: each rank's
    expert block holds its half of the experts (the "model" shard of the
    experts' weights) and its half of their capacity rows (split over
    "data"), filled by an all-to-all from the ranks that route the
    tokens; one train step's loss and first moments of every leaf (0.1 x
    the clipped gradient) equal the unsharded step's, each leaf within
    1e-5 of its largest magnitude.  maverick adds the shared
    expert and top-1 routing, and keeps its moments in bfloat16: there
    a moment may round to the next bfloat16 value, so its leaves are held
    within 2^-8 of their largest magnitude (one bfloat16 step)."""
    from repro_torch import configs
    from repro_torch.models import build, smoke_config
    from repro_torch.models.moe import capacity
    from repro_torch.optim.adamw import adamw_init, make_train_step

    cfg = smoke_config(configs.get(arch))
    rng = np.random.default_rng(37)
    data = {k: rng.integers(0, cfg.vocab, (CELL_B, CELL_S)).astype(np.int32)
            for k in ("tokens", "labels")}
    np.savez(tmp_path / "in.npz", **data)
    run_world(f"""
import json
import numpy as np
import repro_torch.models.moe as moe
from repro_torch import configs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, place_cell
from repro_torch.models import ShapeSpec, smoke_config
cfg = smoke_config(configs.get({arch!r}))
mesh = make_host_mesh(2, device_type="cpu")
seen, ffn = [], moe._ffn


def record(p, cfg, buf):
    seen.append(list(buf.shape[:2]))
    return ffn(p, cfg, buf)


moe._ffn = record
fn, specs, shards, _ = build_cell(cfg, ShapeSpec("t", {CELL_S}, {CELL_B},
                                                 "train"), mesh)
st, m = fn(*place_cell(fn, specs, shards, (dict(np.load(OUT + "/in.npz")),),
                       seed=1, device="cpu"))
mom = {{k: v.full_tensor().float().numpy() for k, v in st.m.items()}}
json.dump(seen, open(OUT + f"/seen{{RANK}}.json", "w"))
if RANK == 0:
    np.savez(OUT + "/m.npz", **mom)
    json.dump(float(m["loss"]), open(OUT + "/loss.json", "w"))
""", 4, tmp_path)
    import json
    half = cfg.n_experts // 2
    # a microbatch's tokens set the capacity
    rows = {-(-capacity(cfg, CELL_B * CELL_S // n) // 2) for n in (1, 2, 4)}
    for rank in range(4):
        seen = json.loads((tmp_path / f"seen{rank}.json").read_text())
        assert seen, rank
        assert all(n == half and nc in rows for n, nc in seen), (rank, seen)
    model = build(cfg, device="cpu", seed=1)
    state, m = make_train_step(model)(adamw_init(model), {
        k: torch.from_numpy(v) for k, v in data.items()})
    got = json.loads((tmp_path / "loss.json").read_text())
    np.testing.assert_allclose(got, float(m["loss"]), **CELL_TOL)
    mom = np.load(tmp_path / "m.npz")
    assert set(mom.files) == set(state.m)
    tol = 2.0 ** -8 if cfg.optimizer_dtype == torch.bfloat16 else 1e-5
    for k, v in state.m.items():
        want = v.float().numpy()
        err = np.abs(mom[k] - want).max()
        assert err <= tol * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_2_7b"])
def test_ssm_cell_runs_each_ranks_heads(tmp_path, arch):
    """The SSM on a 2 x 2 mesh splits its heads over "model" (the "mlp"
    shard of d_inner): every SSD and decode step a rank runs holds half
    the heads.  One train step's loss and the first moments of every leaf
    equal the unsharded step's, each leaf within 1e-4 of its largest
    magnitude (the head-split norm and output sums reorder float32 sums,
    and the gradients of D and dt_bias cancel: zamba2's reach 2.4e-5);
    a decode step from a random cache gives the unsharded
    step's next tokens and every cache leaf within CELL_TOL (the state
    written back shard by shard)."""
    from repro_torch import configs
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build, smoke_config
    from repro_torch.optim.adamw import adamw_init, make_train_step

    cfg = smoke_config(configs.get(arch))
    model = build(cfg, device="cpu", seed=1)
    rng = np.random.default_rng(41)
    data = {k: rng.integers(0, cfg.vocab, (CELL_B, CELL_S)).astype(np.int32)
            for k in ("tokens", "labels")}
    tok = rng.integers(0, cfg.vocab, (CELL_B, 1)).astype(np.int32)
    cache = {f"{j}/{kind}/{k}": rng.standard_normal(v.shape).astype(
                 np.float32)
             for j, d in model.init_cache(CELL_B, CELL_S).items()
             for kind, leaves in d.items() for k, v in leaves.items()}
    np.savez(tmp_path / "in.npz", tok=tok, **data)
    np.savez(tmp_path / "cache.npz", **cache)
    run_world(f"""
import json
import numpy as np
import repro_torch.models.ssm as ssm
from repro_torch import configs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, place_cell
from repro_torch.models import ShapeSpec, smoke_config
cfg = smoke_config(configs.get({arch!r}))
mesh = make_host_mesh(2, device_type="cpu")
seen, ssd, dec = [], ssm._ssd, ssm._decode


def rec_ssd(p, cfg, x):
    seen.append(["ssd", ssm._dims(p, cfg)[0]])
    return ssd(p, cfg, x)


def rec_dec(p, cfg, x, cache):
    seen.append(["decode", ssm._dims(p, cfg)[0]])
    return dec(p, cfg, x, cache)


ssm._ssd, ssm._decode = rec_ssd, rec_dec
d = dict(np.load(OUT + "/in.npz"))
tok = d.pop("tok")
fn, specs, shards, _ = build_cell(cfg, ShapeSpec("t", {CELL_S}, {CELL_B},
                                                 "train"), mesh)
st, m = fn(*place_cell(fn, specs, shards, (d,), seed=1, device="cpu"))
mom = {{k: v.full_tensor().float().numpy() for k, v in st.m.items()}}
cache = {{}}
for name, v in np.load(OUT + "/cache.npz").items():
    j, kind, k = name.split("/")
    cache.setdefault(j, {{}}).setdefault(kind, {{}})[k] = v
fn, specs, shards, _ = build_cell(cfg, ShapeSpec("d", {CELL_S}, {CELL_B},
                                                 "decode"), mesh)
nxt, cache = fn(*place_cell(fn, specs, shards, (tok, cache, 5), seed=1,
                            device="cpu"))
full = {{f"{{j}}/{{kind}}/{{k}}": v.full_tensor().numpy()
        for j, dd in cache.items() for kind, leaves in dd.items()
        for k, v in leaves.items()}}
json.dump(seen, open(OUT + f"/seen{{RANK}}.json", "w"))
if RANK == 0:
    np.savez(OUT + "/m.npz", **mom)
    np.savez(OUT + "/after.npz", **full)
    json.dump({{"loss": float(m["loss"]),
               "next": nxt.full_tensor().flatten().tolist()}},
              open(OUT + "/r.json", "w"))
""", 4, tmp_path, timeout=85)
    import json
    for rank in range(4):
        seen = json.loads((tmp_path / f"seen{rank}.json").read_text())
        assert {k for k, _ in seen} == {"ssd", "decode"}, rank
        assert all(n == cfg.ssm_heads // 2 for _, n in seen), (rank, seen)
    got = json.loads((tmp_path / "r.json").read_text())
    state, m = make_train_step(model)(adamw_init(model), {
        k: torch.from_numpy(v) for k, v in data.items()})
    np.testing.assert_allclose(got["loss"], float(m["loss"]), **CELL_TOL)
    mom = np.load(tmp_path / "m.npz")
    assert set(mom.files) == set(state.m)
    for k, v in state.m.items():
        want = v.float().numpy()
        err = np.abs(mom[k] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)
    full = {}
    for name, v in cache.items():
        j, kind, k = name.split("/")
        full.setdefault(j, {}).setdefault(kind, {})[k] = torch.from_numpy(
            v.copy())
    model = build(cfg, device="cpu", seed=1)
    nxt, full = make_serve_step(model)(torch.from_numpy(tok), full, 5)
    assert got["next"] == nxt.flatten().tolist()
    after = np.load(tmp_path / "after.npz")
    assert set(after.files) == set(cache)
    for name in cache:
        j, kind, k = name.split("/")
        want = full[j][kind][k].numpy()
        np.testing.assert_allclose(after[name], want, **CELL_TOL,
                                   err_msg=name)
        if kind == "ssm":
            assert not np.array_equal(want, cache[name]), name


# the wrappers that see every DTensor redistribution a rank runs: the
# local move (forward, and the ops' implicit moves) under each name it is
# imported by, and the backward of an explicit one before torch
# normalises it (torch 2.11's DTensor runs a backward shard -> partial
# move as asked, and refuses it)
SHARD_TO_PARTIAL_HOOK = """
import torch.distributed.tensor._api as _api
import torch.distributed.tensor._dispatch as _dispatch
import torch.distributed.tensor._redistribute as _redist
from torch.distributed.tensor import Partial, Shard
MOVES = []


def _shard_to_partial(where, cur, tgt):
    bad = [f"{c} -> {t}" for c, t in zip(cur, tgt, strict=True)
           if isinstance(c, Shard) and isinstance(t, Partial)]
    if bad:
        MOVES.append([where, bad])


_local = _redist.redistribute_local_tensor


def _local_hook(local, current_spec, target_spec, **kw):
    _shard_to_partial("forward", current_spec.placements,
                      target_spec.placements)
    return _local(local, current_spec, target_spec, **kw)


for _m in (_redist, _dispatch, _api):
    _m.redistribute_local_tensor = _local_hook
_back = _redist._redistribute_backward


def _back_hook(grad_output, previous_spec, *a, **kw):
    _shard_to_partial("backward", grad_output.placements,
                      previous_spec.placements)
    return _back(grad_output, previous_spec, *a, **kw)


_redist._redistribute_backward = _back_hook
"""


@pytest.mark.parametrize("arch", ["whisper_base", "mamba2_130m",
                                  "olmoe_1b_7b", "zamba2_2_7b"])
def test_train_step_moves_no_shard_into_a_partial_sum(tmp_path, arch):
    """One train step, forward and backward, of the arch's smoke cell on
    2 x 2 gloo ranks, at its own config and at the dry run's probe config
    (one microbatch, no remat), with every DTensor redistribution watched:
    no mesh dim goes from a shard to a partial sum (torch 2.11's DTensor
    refuses that move: whisper's residual add and the SSM's and MoE's
    sums on a mesh asked for it), and each loss is finite."""
    from repro_torch import configs
    from repro_torch.models import smoke_config

    cfg = smoke_config(configs.get(arch))
    rng = np.random.default_rng(43)
    data = {k: rng.integers(0, cfg.vocab, (CELL_B, CELL_S)).astype(np.int32)
            for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        data["frames"] = rng.standard_normal(
            (CELL_B, CELL_S, cfg.d_model)).astype(np.float32)
    np.savez(tmp_path / "in.npz", **data)
    run_world(SHARD_TO_PARTIAL_HOOK + f"""
import json
import numpy as np
from repro_torch import configs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, place_cell
from repro_torch.models import ShapeSpec, smoke_config
mesh = make_host_mesh(2, device_type="cpu")
smoke = smoke_config(configs.get({arch!r}))
out = {{}}
for name, cfg in (("own", smoke),
                  ("probe", smoke.replace(microbatches=1, remat=False))):
    MOVES.clear()
    fn, specs, shards, _ = build_cell(cfg, ShapeSpec("t", {CELL_S},
                                                     {CELL_B}, "train"),
                                      mesh)
    _, m = fn(*place_cell(fn, specs, shards, (dict(np.load(
        OUT + "/in.npz")),), seed=1, device="cpu"))
    out[name] = {{"moves": list(MOVES), "loss": float(m["loss"])}}
json.dump(out, open(OUT + f"/moves{{RANK}}.json", "w"))
""", 4, tmp_path)
    import json
    import math
    for rank in range(4):
        got = json.loads((tmp_path / f"moves{rank}.json").read_text())
        for name, r in got.items():
            assert r["moves"] == [], (rank, name, r["moves"][:4])
            assert math.isfinite(r["loss"]), (rank, name)


# the vocab-sharded xent: (B, S, D, V), the chunk (one chunk and a
# remainder of S - chunk), on 2 x 2 ranks
XENT_SHAPE, XENT_CHUNK = (4, 48, 16, 64), 32


@pytest.mark.parametrize("mask", ["some", "zero"])
def test_vocab_sharded_xent_matches_the_reference(tmp_path, mask):
    """`chunked_softmax_xent` on 2 x 2 gloo ranks: h (B, S, D) split on
    batch ("data") and sequence ("model"), the tied embedding (V, D) on
    vocabulary ("model") and, as FSDP splits it, on D ("data"); labels on
    every vocab shard, a chunk and a remainder, a label mask with zeros
    (or all zero).  The loss and the gradients of h and the embedding
    equal the reference's `chunked_softmax_xent` and its `jax.grad`
    within 1e-5."""
    import jax

    from repro.models.layers import chunked_softmax_xent as r_xent

    b, s, d, v = XENT_SHAPE
    rng = np.random.default_rng(47)
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    emb = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    keep = (rng.random((b, s)) > 0.3) if mask == "some" else np.zeros((b, s))
    keep = keep.astype(np.float32)
    assert {int(x) // (v // 2) for x in labels.flat} == {0, 1}
    np.savez(tmp_path / "in.npz", h=h, emb=emb, labels=labels, mask=keep)
    run_world(f"""
import numpy as np
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.layers import chunked_softmax_xent
mesh = make_host_mesh(2, device_type="cpu")
d = {{k: torch.from_numpy(v) for k, v in np.load(OUT + "/in.npz").items()}}
h = distribute_tensor(d["h"], mesh, (Shard(0), Shard(1))).requires_grad_()
emb = distribute_tensor(d["emb"], mesh, (Shard(1), Shard(0)))
emb.requires_grad_()
rows = (Shard(0), Shard(1))
loss = chunked_softmax_xent(h, emb, distribute_tensor(d["labels"], mesh,
                                                      rows),
                            chunk={XENT_CHUNK},
                            label_mask=distribute_tensor(d["mask"], mesh,
                                                         rows))
loss.backward()
got = {{"loss": loss.detach().full_tensor().numpy(),
       "gh": h.grad.full_tensor().numpy(),
       "ge": emb.grad.full_tensor().numpy()}}
if RANK == 0:
    np.savez(OUT + "/got.npz", **got)
""", 4, tmp_path)

    def ref(h, e):
        return r_xent(h, e, jnp.asarray(labels), chunk=XENT_CHUNK,
                      label_mask=jnp.asarray(keep))

    loss, (gh, ge) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(emb))
    got = np.load(tmp_path / "got.npz")
    np.testing.assert_allclose(got["loss"], np.asarray(loss), **CELL_TOL)
    np.testing.assert_allclose(got["gh"], np.asarray(gh), **CELL_TOL)
    np.testing.assert_allclose(got["ge"], np.asarray(ge), **CELL_TOL)
    if mask == "zero":
        assert float(loss) == 0.0 and not np.asarray(ge).any()


def test_batch_rows_moves_a_microbatch_without_the_whole_batch(tmp_path):
    """`batch_rows` on 2 x 2 gloo ranks: a (6, 4, 3) batch split on its
    rows over "data" (and its dim 1 over "model"), or over both mesh dims
    at once, sliced at consecutive rows as the train step's microbatches
    are: every slice's full tensor equals the plain slice, at the batch's
    placements where its rows split evenly over the ranks that split the
    batch (else whole on each of them), moved by one all-to-all a slice
    and no all-gather."""
    run_world("""
import json
import math
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.sharding import batch_rows
mesh = make_host_mesh(2, device_type="cpu")
full = torch.arange(6 * 4 * 3, dtype=torch.float32).reshape(6, 4, 3)
out = []
for pl in ((Shard(0), Shard(1)), (Shard(0), Shard(0))):
    x = distribute_tensor(full, mesh, pl)
    for lo, hi in ((0, 3), (3, 6), (0, 2), (2, 4), (4, 6), (1, 2), (5, 6),
                   (0, 6)):
        r = analyze_step(batch_rows, x, lo, hi)
        part = r["out"]
        n = math.prod(mesh.size(i) for i, p in enumerate(pl)
                      if p == Shard(0))
        want = pl if (hi - lo) % n == 0 else tuple(
            Replicate() if p == Shard(0) else p for p in pl)
        assert part.placements == want, (pl, lo, hi, part.placements)
        assert torch.equal(part.full_tensor(), full[lo:hi]), (pl, lo, hi)
        out.append(r["collectives"]["counts_by_type"])
if RANK == 0:
    json.dump(out, open(OUT + "/counts.json", "w"))
""", 4, tmp_path)
    import json
    counts = json.loads((tmp_path / "counts.json").read_text())
    assert len(counts) == 16
    for c in counts:
        assert c["all-to-all"] == 1
        assert sum(c.values()) == 1, c
