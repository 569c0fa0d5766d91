"""The dry run (`repro_torch.launch.dryrun`, `launch.perf`) against the
reference's, on the CPU.

A dry run counts a cell's step on fake tensors in a world of fake ranks,
and the default process group is global: every fake world runs in a
subprocess.  The reference's `repro.launch.dryrun` sets `XLA_FLAGS` when
it is imported, so its side runs in a JAX subprocess too.  Checked: the
probe configs and the applicability of every arch x STANDARD_SHAPE
against the reference's; a dry count of lm2m's three cells equal to
`analyze_step` on rank 0 of a real gloo world of four ranks; the MoE's
full-capacity dispatch on a fake world against a hand count; the probes'
and `depth_count`'s lines against full-depth counts; `bytes_accessed`
and the temp bytes of a tiny function by hand; `run_cell` on the (32, 8)
production mesh in a fake world of 256; `perf.compare` against the
reference's; the reference's mini dry run; a failing cell; the fake
world remade at a new size and refused over a real one."""

import json
import math
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch_world import ROOT, finish, run_world, start_jax

from repro import configs as rconfigs
from repro.models import active_params as r_active_params
from repro.models import count_params as r_count_params
from repro_torch import configs
from repro_torch.launch import dryrun, perf
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.models import STANDARD_SHAPES, ModelConfig, smoke_config

torch.set_num_threads(1)


def _fake(body: str, timeout: float = 85.0) -> dict:
    """Run `body` in a fresh process (the port only, one thread); its
    last line of output is JSON."""
    code = "import json\nimport torch\ntorch.set_num_threads(1)\n" + \
        textwrap.dedent(body)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=timeout,
                         env={"PYTHONPATH": f"{ROOT}/src",
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _fields(cfg) -> dict:
    """A config's fields, dtypes by name (torch's and numpy's alike)."""
    return {k: (str(v).removeprefix("torch.") if isinstance(v, torch.dtype)
                else np.dtype(v).name) if "dtype" in k else v
            for k, v in vars(cfg).items()}


def test_probe_configs_and_skips_equal_the_references(tmp_path):
    """`_with_supers` at k = 2 and 4 and `cell_applicable`, for every arch
    x STANDARD_SHAPE, field for field; the long_500k skip records carry
    the reference's reason and tag (mesh named 32x8 for 16x16)."""
    proc = start_jax(f"""
import json
from pathlib import Path
import numpy as np
from repro import configs
from repro.launch import dryrun as R
from repro.models import STANDARD_SHAPES
R.OUT_DIR = Path({str(tmp_path / "ref")!r})
out = {{}}
for arch in configs.ARCHS:
    cfg = configs.get(arch)
    for spec in STANDARD_SHAPES:
        key = arch + "|" + spec.name
        out[key] = {{"ok": R.cell_applicable(cfg, spec.name)}}
        for k in (2, 4):
            c = R._with_supers(cfg, k, spec.seq_len)
            out[key][k] = {{f: (np.dtype(v).name if "dtype" in f else v)
                           for f, v in vars(c).items()}}
        if not out[key]["ok"]:
            out[key]["rec"] = R.run_cell(arch, spec.name, False)
json.dump(out, open(OUT + "/ref.json", "w"))
""", tmp_path)
    dryrun_out = dryrun.OUT_DIR
    dryrun.OUT_DIR = tmp_path / "port"
    try:
        skips = {}
        for arch in configs.ARCHS:
            for spec in STANDARD_SHAPES:
                if not dryrun.cell_applicable(configs.get(arch), spec.name):
                    skips[arch] = dryrun.run_cell(arch, spec.name, False,
                                                  device="cpu")
    finally:
        dryrun.OUT_DIR = dryrun_out
    finish(proc)
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert len(ref) == 40
    for arch in configs.ARCHS:
        cfg = configs.get(arch)
        for spec in STANDARD_SHAPES:
            want = ref[f"{arch}|{spec.name}"]
            assert dryrun.cell_applicable(cfg, spec.name) == want["ok"]
            for k in (2, 4):
                have = _fields(dryrun._with_supers(cfg, k, spec.seq_len))
                # the port's own fields (the pattern family's) at their
                # defaults, the reference's field for field
                extra = set(have) - set(want[str(k)])
                assert {f: have.pop(f) for f in extra} == {
                    f: _fields(ModelConfig())[f] for f in extra}, \
                    (arch, spec, k)
                assert have == want[str(k)], (arch, spec, k)
            if not want["ok"]:
                got = skips[arch]
                assert got["reason"] == want["rec"]["reason"]
                assert got["skipped"] is True
                assert got["tag"] == want["rec"]["tag"].replace("16x16",
                                                                "32x8")
    assert sorted(skips) == sorted(
        a for a in configs.ARCHS
        if configs.get(a).family not in dryrun.LONG_OK_FAMILIES)
    assert (tmp_path / "port" / "phi4_mini_3_8b__long_500k__32x8.json"
            ).exists()


# lm2m's cells on a (2, 2) mesh: (name, kind, sequence), batch CELL_B
CELLS = (("train", "train", 64), ("prefill", "prefill", 64),
         ("decode", "decode", 128))
CELL_B = 4
COUNT_KEYS = ("flops", "bytes_accessed", "collectives", "memory_analysis",
              "peak_bytes")


def test_dry_count_equals_a_real_count(tmp_path):
    """lm2m's train, prefill and decode cells on a (2, 2) mesh, counted on
    fake tensors in a fake world of 4 and by `analyze_step` on rank 0 of
    a real gloo world of 4 (weights from a seed, random tokens): flops,
    bytes accessed, collectives by type (bytes and counts), argument,
    output and temp bytes, and the peak, all equal."""
    run_world(f"""
import json
import numpy as np
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, place_cell
from repro_torch.launch.train import PRESETS
from repro_torch.models import ShapeSpec
cfg = PRESETS["lm2m"]
mesh = make_host_mesh(2, device_type="cpu")
rng = np.random.default_rng(0)
out = {{}}
for name, kind, s in {CELLS!r}:
    fn, specs, shards, _ = build_cell(cfg, ShapeSpec(name, s, {CELL_B},
                                                     kind), mesh)
    if kind == "decode":
        tok = rng.integers(0, cfg.vocab, ({CELL_B}, 1)).astype(np.int32)
        args = place_cell(fn, specs, shards, (tok, None, s - 1), seed=0,
                          device="cpu")
    else:
        data = {{k: rng.integers(0, cfg.vocab, ({CELL_B}, s)).astype(
                    np.int32) for k in ("tokens", "labels")[
                        :2 if kind == "train" else 1]}}
        args = place_cell(fn, specs, shards, (data,), seed=0, device="cpu")
    r = analyze_step(fn, *args)
    out[name] = {{k: r[k] for k in {COUNT_KEYS!r}}}
if RANK == 0:
    json.dump(out, open(OUT + "/real.json", "w"))
""", 4, tmp_path)
    dry = _fake(f"""
from repro_torch.launch.dryrun import count_cell, fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import PRESETS
from repro_torch.models import ShapeSpec
fake_world(4)
mesh = make_host_mesh(2, device_type="cpu")
out = {{}}
for name, kind, s in {CELLS!r}:
    r = count_cell(PRESETS["lm2m"], ShapeSpec(name, s, {CELL_B}, kind),
                   mesh, device="cpu")
    out[name] = {{k: r[k] for k in {COUNT_KEYS!r}}}
print(json.dumps(out))
""")
    real = json.loads((tmp_path / "real.json").read_text())
    for name, _, _ in CELLS:
        assert dry[name] == real[name], name
        assert real[name]["flops"] > 0
        assert real[name]["memory_analysis"]["temp_size_in_bytes"] > 0
    assert real["train"]["collectives"]["total_ops"] > 0
    assert real["decode"]["collectives"]["counts_by_type"]["all-gather"] > 0


@pytest.fixture(scope="module")
def olmoe_mini():
    """olmoe at smoke size, ShapeSpec("mini", 128, 8, "train"), counted on
    a (4, 2) mesh in a fake world of 8 (the reference's mini dry run)."""
    return _fake("""
from repro_torch import configs
from repro_torch.launch.dryrun import count_cell, fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ShapeSpec, smoke_config
fake_world(8)
mesh = make_host_mesh(2, device_type="cpu")
r = count_cell(smoke_config(configs.get("olmoe_1b_7b")),
               ShapeSpec("mini", 128, 8, "train"), mesh, device="cpu")
print(json.dumps({k: r[k] for k in ("flops", "collectives", "peak_bytes")}))
""")


def test_moe_cell_counts_full_capacity_on_a_fake_world(olmoe_mini):
    """The MoE's dispatch on fake tensors reaches no data-dependent op (a
    FakeTensorMode without a shape environment raises on any): every
    (expert, capacity row) cell is taken as full, so each MoE layer of
    each microbatch moves this rank's ne x nc rows out and back and their
    two gradients (d floats each) and their (expert, row) pairs (two
    int64).  Besides, each microbatch's rows of tokens and labels come by
    one all-to-all each (`batch_rows`): 2 rows, which do not split over 4
    data ranks, so each takes both, and rank 0, which holds them for the
    first microbatch (its 64 of the 128 positions, int32), sends them to
    all 4.  Nothing else goes by all-to-all."""
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import super_block_spec

    cfg = smoke_config(configs.get("olmoe_1b_7b"))
    data, model = 4, 2
    mb = cfg.microbatches
    tokens = 8 // mb * 128                  # a microbatch's tokens
    ne = cfg.n_experts // model             # experts over "model"
    nc = -(-capacity(cfg, tokens) // data)  # capacity rows over "data"
    layers = cfg.n_layers // len(super_block_spec(cfg)) * \
        super_block_spec(cfg).count("moe")
    rows = ne * nc
    per_layer = 4 * rows * cfg.d_model * 4 + rows * 2 * 8
    batch = 2 * data * (8 // data) * (128 // model) * 4
    assert 8 // mb == 8 // data and (8 // mb) % data
    c = olmoe_mini["collectives"]
    assert c["bytes_by_type"]["all-to-all"] == layers * mb * per_layer + \
        batch
    assert c["counts_by_type"]["all-to-all"] == layers * mb * 5 + 2 * mb


def test_mini_dry_run_counts_flops_and_collectives(olmoe_mini):
    """The counterpart of the reference's `test_mini_dryrun_lowering`."""
    assert olmoe_mini["flops"] > 0
    assert olmoe_mini["collectives"]["total_ops"] > 0
    assert olmoe_mini["peak_bytes"] > 0


# (arch, layers) at smoke size: a dense, an ssm and an encdec arch
PROBED = (("phi4_mini_3_8b", 6), ("mamba2_130m", 6), ("whisper_base", 5))


@pytest.mark.parametrize("arch,layers", PROBED)
def test_probes_extrapolate_to_the_full_depth_count(arch, layers):
    """With remat off and one microbatch, `probe_costs`' line through the
    counts at 2 and 4 super-blocks, evaluated at the cell's depth, equals
    the full-depth count: flops and every collective type's bytes exactly
    (integers; the line's arithmetic is exact in float64 here), bytes
    accessed within 1e-12 relative."""
    out = _fake(f"""
from repro_torch import configs
from repro_torch.launch.dryrun import count_cell, fake_world, probe_costs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ShapeSpec, smoke_config
fake_world(4)
mesh = make_host_mesh(2, device_type="cpu")
cfg = smoke_config(configs.get({arch!r}))
depth = {{"n_layers": {layers}}}
if cfg.family == "encdec":
    depth.update(enc_layers={layers}, dec_layers={layers})
cfg = cfg.replace(remat=False, microbatches=1, **depth)
spec = ShapeSpec("t", 64, 4, "train")
full = count_cell(cfg, spec, mesh, device="cpu")
probe = probe_costs(cfg, spec, mesh, None, device="cpu")
print(json.dumps({{"full": {{k: full[k] for k in ("flops", "bytes_accessed",
                                               "collectives")}},
                  "probe": probe}}))
""")
    full, probe = out["full"], out["probe"]
    assert probe["flops"] == full["flops"] > 0
    assert probe["collective_bytes_by_type"] == {
        k: float(v) for k, v in full["collectives"]["bytes_by_type"].items()}
    assert probe["collective_bytes_total_mb_scaled"] == \
        full["collectives"]["total_bytes"]
    assert math.isclose(probe["bytes_accessed"], full["bytes_accessed"],
                        rel_tol=1e-12)
    assert probe["microbatches"] == 1


@pytest.mark.parametrize("arch,layers", (("phi4_mini_3_8b", 6),
                                         ("olmoe_1b_7b", 8)))
def test_depth_count_equals_the_full_depth_count(arch, layers):
    """`depth_count` (the line through the cell's own config at 2 and 4
    super-blocks: two microbatches, remat on) against `count_cell` at the
    full depth: flops, bytes accessed, every collective count and byte,
    argument and output bytes equal; the temp bytes, whose peak may sit
    a little off the line, within 5% (phi4 at this size: 4.2% under)."""
    out = _fake(f"""
from repro_torch import configs
from repro_torch.launch.dryrun import count_cell, depth_count, fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ShapeSpec, smoke_config
fake_world(4)
mesh = make_host_mesh(2, device_type="cpu")
cfg = smoke_config(configs.get({arch!r})).replace(
    remat=True, microbatches=2, n_layers={layers})
spec = ShapeSpec("t", 64, 4, "train")
print(json.dumps({{"full": count_cell(cfg, spec, mesh, device="cpu"),
                  "line": depth_count(cfg, spec, mesh, device="cpu")}}))
""")
    full, line = out["full"], out["line"]
    assert line.pop("counted_at") == [2, 4]
    temp = [d["memory_analysis"].pop("temp_size_in_bytes")
            for d in (full, line)]
    for d in (full, line):
        d.pop("peak_bytes")
    assert line == full
    assert full["flops"] > 0 and full["collectives"]["total_ops"] > 0
    assert abs(temp[1] / temp[0] - 1) <= 0.05


# a train cell with phi4-mini's full vocabulary: (batch, seq) on (4, 2)
XENT_CELL = (16, 128)


def test_xent_logits_stay_on_the_local_batch_and_vocab_shard():
    """phi4-mini at smoke width, two layers, its full 200,064-token
    vocabulary, a train cell of 16 x 128 on a (4, 2) mesh, counted on
    fake tensors in a fake world of 8: the largest float32 (b, c, v)
    tensor any op makes on a rank (the xent chunk's logits, their
    exponentials, their gradient) holds at most B/4 x c x V/2 x 4 B, this
    rank's rows of the batch and columns of the vocab; an embedding that
    FSDP splits on "data" is gathered for the product, not the batch."""
    out = _fake(f"""
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import configs
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.hlo_analysis import (_StepRecorder, _leaves,
                                             _without_shape_inference)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_cell, place_zeros
from repro_torch.models import ShapeSpec, smoke_config
V = configs.get("phi4_mini_3_8b").vocab


class Logits(_StepRecorder):
    big = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and not self.paused:
            for t in _leaves(out):
                if (t.dtype == torch.float32 and t.dim() == 3
                        and t.shape[-1] >= V // 2):
                    self.big = max(self.big, t.untyped_storage().nbytes())
        return out


fake_world(8)
mesh = make_host_mesh(2, device_type="cpu")
cfg = smoke_config(configs.get("phi4_mini_3_8b")).replace(
    vocab=V, n_layers=2, microbatches=1)
fn, specs, shards, _ = build_cell(cfg, ShapeSpec("t", {XENT_CELL[1]},
                                                 {XENT_CELL[0]}, "train"),
                                  mesh)
rec = Logits()
with FakeTensorMode():
    args = place_zeros(fn, specs, shards, device="cpu")
    with _without_shape_inference(rec), rec:
        fn(*args)
print(json.dumps({{"big": rec.big, "vocab": V, "chunk": cfg.xent_chunk,
                  "mesh": list(mesh.shape)}}))
""")
    b, s = XENT_CELL
    v, c = out["vocab"], min(out["chunk"], s)
    assert out["mesh"] == [4, 2] and v == 200_064
    assert 0 < out["big"] <= b // 4 * c * (v // 2) * 4


def test_bytes_accessed_and_temp_bytes_by_hand():
    """relu(a @ b), a (4, 8) and b (8, 16) float32: the matmul reads 128 +
    512 B and writes 256, the relu reads and writes 256; the product and
    the result are live together (512 B beyond the arguments), the result
    is 256 B.  Views move nothing.  Real and fake tensors give the same
    counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def f(a, b):
        return torch.relu(a @ b).t()

    want = {"flops": 2 * 4 * 8 * 16.0, "bytes_accessed": 128 + 512 + 256
            + 256 + 256, "argument_bytes": 640, "peak_bytes": 640 + 512,
            "memory_analysis": {"argument_size_in_bytes": 640,
                                "output_size_in_bytes": 256,
                                "temp_size_in_bytes": 512}}
    a, b = torch.randn(4, 8), torch.randn(8, 16)
    real = analyze_step(f, a, b)
    assert torch.equal(real.pop("out"), f(a, b))
    with FakeTensorMode():
        fake = analyze_step(f, torch.empty(4, 8), torch.empty(8, 16))
    fake.pop("out")
    for r in (real, fake):
        assert r["collectives"]["total_ops"] == 0
        assert {k: r[k] for k in want} == want


def test_peak_tensors_are_the_largest_storages_live_at_the_peak():
    """`analyze_step(..., peak_tensors=2)` of relu(a @ b) with a (4, 8)
    and b (8, 16) float32: at the peak the product and the result are
    live, 256 B each, made by `mm` and `relu`; `count_cell` records them
    by depth in a dry run of lm2m's train cell, largest first."""
    def f(a, b):
        return torch.relu(a @ b)

    r = analyze_step(f, torch.randn(4, 8), torch.randn(8, 16),
                     peak_tensors=2)
    assert sorted(t["op"] for t in r["peak_tensors"]) == ["mm", "relu"]
    assert all(t["shape"] == [4, 16] and t["dtype"] == "float32"
               and t["bytes"] == 256 for t in r["peak_tensors"])
    assert sum(t["bytes"] for t in r["peak_tensors"]) == \
        r["memory_analysis"]["temp_size_in_bytes"]
    assert "peak_tensors" not in analyze_step(f, torch.randn(4, 8),
                                              torch.randn(8, 16))
    out = _fake("""
from repro_torch.launch.dryrun import depth_count, fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import PRESETS
from repro_torch.models import ShapeSpec
fake_world(4)
r = depth_count(PRESETS["lm2m"], ShapeSpec("t", 64, 4, "train"),
                make_host_mesh(2, device_type="cpu"), device="cpu",
                peak_tensors=5)
print(json.dumps({"tops": r["peak_tensors"], "temp": r["memory_analysis"][
    "temp_size_in_bytes"], "at": r["counted_at"]}))
""")
    tops = out["tops"]
    assert list(tops) == [str(n) for n in out["at"]]
    for top in tops.values():
        sizes = [t["bytes"] for t in top]
        assert len(top) == 5 and sizes == sorted(sizes, reverse=True)
        assert 0 < sum(sizes) <= out["temp"]


def test_run_cell_on_the_production_mesh():
    """mamba2-130m's decode_32k at full width on the (32, 8) mesh, in a
    fake world of 256 ranks on the CPU: ok, every key of the reference's
    record (lower_s / compile_s become count_s), the reference's
    parameter counts, the record written under experiments/torch_dryrun/,
    and every count equal to the count at the cell's own depth."""
    assert dryrun.OUT_DIR == ROOT_PATH / "experiments" / "torch_dryrun"
    rec = _fake("""
from repro_torch.launch.dryrun import OUT_DIR, run_cell
full = run_cell("mamba2_130m", "decode_32k", False, force=True,
                device="cpu", full_depth=True)
rec = run_cell("mamba2_130m", "decode_32k", False, force=True, device="cpu")
rec["written"] = json.loads((OUT_DIR / (rec["tag"] + ".json")).read_text())
rec["full"] = full
print(json.dumps(rec))
""")
    full = rec.pop("full")
    assert rec.pop("written") == rec
    # the line through 2 and 4 super-blocks against the count at all 24
    assert (rec["counted_at"], full["counted_at"]) == ([2, 4], [24])
    for key in ("flops", "bytes_accessed", "collectives", "memory_analysis",
                "peak_bytes", "extrapolated", "roofline"):
        assert rec[key] == full[key], key
    assert rec["ok"] is True and "probe_error" not in rec
    for key in ("tag", "arch", "shape", "mesh", "variant", "chips", "family",
                "params", "active_params", "seq_len", "global_batch",
                "kind", "ok", "extrapolated", "roofline", "flops",
                "bytes_accessed", "collectives", "memory_analysis",
                "count_s"):
        assert key in rec, key
    assert rec["tag"] == "mamba2_130m__decode_32k__32x8"
    assert (rec["mesh"], rec["chips"], rec["kind"]) == ("32x8", 256,
                                                        "decode")
    rcfg = rconfigs.get("mamba2_130m")
    assert rec["params"] == r_count_params(rcfg) == 128_710_656
    assert rec["active_params"] == r_active_params(rcfg)
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes"}
    assert rec["peak_bytes"] == rec["memory_analysis"][
        "argument_size_in_bytes"] + rec["memory_analysis"][
        "temp_size_in_bytes"]
    roof = rec["roofline"]
    assert roof["dominant"] == max(("compute_s", "memory_s",
                                    "collective_s"), key=roof.get)
    assert roof["collective_s"] == rec["extrapolated"][
        "collective_bytes_total_mb_scaled"] / 450e9


ROOT_PATH = dryrun.OUT_DIR.parents[1]

# the fixed records `compare` reads: one counted, one failed
RECORDS = {
    "base": {"ok": True,
             "roofline": {"compute_s": 0.5, "memory_s": 1.25,
                          "collective_s": 0.75, "dominant": "memory_s"},
             "memory_analysis": {"temp_size_in_bytes": 123,
                                 "argument_size_in_bytes": 456},
             "extrapolated": {"collective_bytes_by_type": {
                 "all-gather": 7.0, "all-reduce": 1.0}}},
    "no_fsdp": {"ok": False, "error": "RuntimeError('boom')"},
}


def test_perf_compare_equals_the_references(tmp_path, monkeypatch):
    proc = start_jax(f"""
import json
from repro.launch import perf
RECORDS = {RECORDS!r}
perf.run_cell = lambda arch, shape, mp, v, force=False: RECORDS[v]
rows = perf.compare("phi4_mini_3_8b", "decode_32k", ["base", "no_fsdp"])
json.dump(rows, open(OUT + "/rows.json", "w"))
""", tmp_path)
    seen = []

    def fake_run_cell(arch, shape, mp, v, force=False, device="cuda"):
        seen.append((arch, shape, mp, v, force, device))
        return RECORDS[v]

    monkeypatch.setattr(perf, "run_cell", fake_run_cell)
    rows = perf.compare("phi4_mini_3_8b", "decode_32k", ["base", "no_fsdp"],
                        device="cpu")
    finish(proc)
    assert json.loads(json.dumps(rows)) == json.loads(
        (tmp_path / "rows.json").read_text())
    assert rows[0]["bound_s"] == 1.25 and rows[1]["error"]
    assert seen[0] == ("phi4_mini_3_8b", "decode_32k", False, "base", False,
                       "cpu")


def test_a_failing_cell_is_recorded_and_main_exits_1(tmp_path):
    """A cell whose count raises is recorded ok false with the error and
    its traceback (never raised), and `main` exits 1."""
    out = _fake(f"""
from pathlib import Path
from repro_torch.launch import dryrun
dryrun.OUT_DIR = Path({str(tmp_path)!r})
def boom(*a, **kw):
    raise RuntimeError("no cell here")
dryrun.build_cell = boom
try:
    dryrun.main(["--arch", "phi4-mini-3-8b", "--shape", "train_4k",
                 "--device", "cpu"])
    code = 0
except SystemExit as e:
    code = e.code
rec = json.loads((dryrun.OUT_DIR /
                  "phi4_mini_3_8b__train_4k__32x8.json").read_text())
print(json.dumps({{"code": code, "rec": rec}}))
""")
    assert out["code"] == 1
    rec = out["rec"]
    assert rec["ok"] is False and "no cell here" in rec["error"]
    assert "Traceback" in rec["traceback"] and "boom" in rec["traceback"]
    assert "roofline" not in rec


def test_sweep_runs_each_cell_in_a_process_of_its_own(tmp_path):
    """`--all --jobs N`'s runner: each cell counted by the module in a
    process of its own, N at a time; the records come back in the order
    the processes end (a skip is a record), and a cell whose process
    dies without one (an unknown arch) is ok false with its exit code."""
    out = _fake(f"""
from pathlib import Path
from repro_torch.launch import dryrun
recs = dryrun._sweep_in_processes(
    [("phi4_mini_3_8b", "long_500k", False), ("no_such_arch", "decode_32k",
                                              False),
     ("qwen3_8b", "long_500k", False)], "base",
    ["--device", "cpu", "--force"], 2)
print(json.dumps(recs))
""", timeout=120)
    by_tag = {r["tag"]: r for r in out}
    assert sorted(by_tag) == ["no_such_arch__decode_32k__32x8",
                              "phi4_mini_3_8b__long_500k__32x8",
                              "qwen3_8b__long_500k__32x8"]
    assert by_tag["no_such_arch__decode_32k__32x8"] == {
        "tag": "no_such_arch__decode_32k__32x8", "ok": False,
        "error": "exit 1"}
    for arch in ("phi4_mini_3_8b", "qwen3_8b"):
        assert by_tag[f"{arch}__long_500k__32x8"]["skipped"] is True


def test_fake_world_is_remade_at_a_new_size_and_refuses_a_real_one():
    out = _fake("""
import torch.distributed as dist
from repro_torch.launch.dryrun import fake_world
sizes = []
for n in (4, 4, 8):
    fake_world(n)
    sizes.append([dist.get_backend(), dist.get_world_size()])
dist.destroy_process_group()
dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
try:
    fake_world(256)
    refused = None
except RuntimeError as e:
    refused = str(e)
print(json.dumps({"sizes": sizes, "refused": refused,
                  "still": dist.get_backend()}))
""")
    assert out["sizes"] == [["fake", 4], ["fake", 4], ["fake", 8]]
    assert "real one (gloo, 1 ranks)" in out["refused"]
    assert out["still"] == "gloo"


def test_dry_run_needs_a_card_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_cell("phi4_mini_3_8b", "train_4k", False, force=True)
