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
