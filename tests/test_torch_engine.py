"""The port's trace engine (`repro_torch.core.engine`, its step as the plain
version of E1 in `repro_torch.kernels.engine_scan`) against the JAX
reference's `run_chunk` under `jax.vmap`, on the CPU.

The same numpy traces, fit bitmaps and (flags, params) rows go through both;
every carry tensor (the five LLC arrays, mem_state, the LCT, the metadata
cache, counter, clock, stats) must be equal, not only the stats.  Covered:
the engine's tables, the workload generators for all 27 names, every
registry row at the default SimConfig and at a second one, `variant` rows
that change the counter init, the sampling threshold and the metadata
sets, seeded random flag points on a small config, chunked runs with a
ragged last chunk, and a hand-made trace that evicts the last group and
misses into empty victim ways.
"""

import ctypes
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batchsim as ref_batchsim
from repro.core import engine as ref_engine
from repro.core import schemes as ref_schemes
from repro.core import traces as ref_traces
from repro.core.evict_logic import build_evict_table as ref_evict_table
from repro_torch.core import engine, schemes, traces
from repro_torch.core.engine import SimConfig, run_trace
from repro_torch.core.evict_logic import build_evict_table, evict_table_index
from repro_torch.kernels import engine_scan as es

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS = tuple(ref_schemes.names())          # the 10 registry rows
CFG2 = dict(llc_sets=64, llc_ways=4, meta_sets=32, compress_clean=False)
SMALL = dict(llc_sets=16, llc_ways=2, n_groups=512)
CARRY_NAMES = ("tag", "lru", "valid", "dirty", "pf", "mem_state", "lct",
               "mtag", "mlru", "mdirty", "mclock", "counter", "clock",
               "stats")


def _flat(carry):
    (tag, lru, valid, dirty, pf, mem, lct, meta, counter, clock,
     stats) = carry
    return (tag, lru, valid, dirty, pf, mem, lct, *meta, counter, clock,
            stats)


def ref_carry(cfg_kw, flags, params, trace):
    """The reference's carry after one vmapped `run_chunk` over the whole
    trace (its chunked sweep path, one chunk), as numpy arrays."""
    cfg = ref_engine.SimConfig(**cfg_kw)
    init_s, chunk = ref_batchsim._jit_sweep_chunked(cfg)
    n_w = trace[0].shape[0]
    per = init_s(jnp.asarray(params))
    carry = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[:, None], (x.shape[0], n_w)
                                   + x.shape[1:]), per)
    out = chunk(carry, jnp.asarray(flags), jnp.asarray(params),
                *(jnp.asarray(x) for x in trace))
    return [np.asarray(x) for x in _flat(out)]


def port_carry(cfg_kw, flags, params, trace, chunk_size=None):
    carry = run_trace(SimConfig(**cfg_kw), flags, params, *trace,
                      chunk_size=chunk_size, device="cpu")
    return [x.numpy() for x in _flat(carry)]


def assert_carry_equal(got, want, what=""):
    assert len(got) == len(want) == len(CARRY_NAMES)
    for name, g, w in zip(CARRY_NAMES, got, want, strict=True):
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        assert g.dtype == w.dtype, (what, name, g.dtype, w.dtype)
        assert np.array_equal(g, w), (what, name)


def stacked(names, n_events, seed):
    built = [ref_traces.build_workload(n, n_events, seed) for n in names]
    return tuple(np.stack([b[i] for b in built]) for i in range(1, 6))


def rows_matrices(rows, cfg_kw, port: bool):
    reg = schemes if port else ref_schemes
    cfg = (SimConfig if port else ref_engine.SimConfig)(**cfg_kw)
    return reg.flags_matrix(rows), reg.params_matrix(rows, cfg)


@pytest.fixture(scope="module")
def trace2():
    return stacked(("libq", "pr_twi"), 2000, 0)


# ------------------------------------------------------------------- tables

@pytest.mark.parametrize("compress_clean", [True, False])
def test_evict_table_equals_reference(compress_clean):
    got, want = build_evict_table(compress_clean), ref_evict_table(
        compress_clean)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    idx = evict_table_index(1, 3, 1, 0, 1, 15, 9)
    t = evict_table_index(torch.tensor([1, 0]), torch.tensor([3, 4]),
                          torch.tensor([1, 1]), torch.tensor([0, 1]),
                          torch.tensor([1, 0]), torch.tensor([15, 7]),
                          torch.tensor([9, 2]))
    assert t.dtype == torch.int64 and int(t[0]) == idx
    assert int(t[1]) == evict_table_index(0, 4, 1, 1, 0, 7, 2)


@pytest.mark.parametrize("sets", [16, 64, 128])
def test_engine_tables_equal_reference(sets):
    cfg = SimConfig(llc_sets=sets)
    tables = engine.engine_tables(cfg)
    assert set(tables) == set(es.TABLE_NAMES)
    from repro.compression import layouts as ref_layouts
    want = {"probe": ref_engine._probe_count_table(),
            "loc": ref_layouts.LOC, "lanes_in_slot": ref_layouts.LANES_IN_SLOT,
            "lane_level": ref_layouts.LANE_LEVEL,
            "set_hash": ref_engine._set_hash_table(sets),
            **ref_evict_table(True)}
    for k, v in want.items():
        assert tables[k].dtype == np.int32
        assert np.array_equal(tables[k], v), k
    consts = engine.engine_consts(cfg)
    from repro.compression import gate as ref_gate
    from repro.compression import predictor as ref_pred
    assert consts == {"enable_threshold": ref_gate.ENABLE_THRESHOLD,
                      "counter_max": ref_gate.COUNTER_MAX,
                      "hash_mult": ref_pred.HASH_MULT,
                      "lines_per_page": ref_pred.LINES_PER_PAGE,
                      "groups_per_meta": cfg.groups_per_meta}


def test_layout_indices_equal_reference():
    names = [n for n in ref_engine.__all__
             if n.startswith(("ST_", "FLAG_", "PARAM_", "N_"))]
    assert len(names) == 29
    for n in names:
        assert getattr(engine, n) == getattr(ref_engine, n), n
    assert engine.STAT_NAMES == ref_engine.STAT_NAMES
    assert engine.default_params(SimConfig()) == ref_engine.default_params(
        ref_engine.SimConfig())
    assert dataclasses.asdict(SimConfig()) == dataclasses.asdict(
        ref_engine.SimConfig())
    for rate in (0.0, 0.01, 0.08, 0.5, 1.0):
        assert engine.sample_threshold(rate) == \
            ref_engine.sample_threshold(rate)


def test_cuda_source_matches_the_python_layouts():
    """E1's enums, its table constants and its argument struct, read from
    the source, agree with the layouts in Python and with the ctypes
    struct field by field; the shared-memory layout the C entry expects
    (`smem_layout`, evaluated from the source) equals `smem_bytes`."""
    src = (ROOT / "src/repro_torch/csrc/engine_scan.cu").read_text()
    for name, value in re.findall(r"\b((?:ST|FLAG|PARAM|N)_[A-Z_]+) = (\d+)",
                                  src):
        assert getattr(es, name) == int(value), name
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    env = {}
    for name in ("MEM_STATES", "LANE_MASKS", "EVICT_ENTRIES", "EVICT_BITS",
                 "GROUP_LANES", "SLOT_TABLE", "WARP", "QUEUE"):
        env[name] = eval(consts[name], dict(env))
    for name in ("MEM_STATES", "LANE_MASKS", "EVICT_ENTRIES", "EVICT_BITS"):
        assert env[name] == getattr(es, name), name
    assert env["QUEUE"] == es.META_QUEUE
    assert env["SLOT_TABLE"] == es.MEM_STATES * env["GROUP_LANES"]
    body = src.split("struct EngineArgs {", 1)[1].split("};", 1)[0]
    body = re.sub(r"//[^\n]*", "", body)
    fields = [f.strip().split()[-1].lstrip("*")
              for decl in body.split(";") if decl.strip()
              for f in decl.replace("const ", "").split(",")]
    assert fields == [f[0] for f in es._Args._fields_]
    assert all(ctypes.sizeof(t) == 8 for _, t in es._Args._fields_)
    layout = src.split("long long smem_layout(", 1)[1]
    layout = " ".join(layout.split("return", 1)[1].split(";", 1)[0].split())
    assert "smem_layout(a.sets * a.ways,\n" in src
    env["up16"] = lambda n: (n + 15) // 16 * 16
    for sets, ways, ms, mw, lct, lv in ((128, 8, 64, 8, 512, 3),
                                        (5, 3, 3, 3, 7, 2), (4, 40, 2, 40,
                                                             512, 3)):
        got = eval(layout, env | dict(sw=sets * ways, mm=ms * mw, lct=lct,
                                      n_levels=lv))
        assert got == es.smem_bytes(sets, ways, ms, mw, lct, lv)


def test_smem_bytes():
    """The lane's state, the shadow, the tables (eviction table packed to
    16 bits an entry; PROBE, LOC, LANES_IN_SLOT, LANE_LEVEL int32) and the
    metadata-cache queue (2 x 64 requests, 2 counts), each region rounded
    up to 16 bytes: 68,592 B at the defaults, so 3 CTAs fit on an SM."""
    tables = 40_960 + 240 + 3 * 80 + 512 + 16
    assert es.smem_bytes(128, 8, 64, 8, 512, 3) == 25_600 + 1024 + tables
    assert es.smem_bytes(128, 8, 64, 8, 512, 3) == 68_592
    assert 3 * (68_592 + 1024) <= 228 * 1024
    assert es.smem_bytes(64, 4, 32, 8, 512, 3) == (5120 + 2048 + 256 + 512
                                                   + 256 + tables)
    assert es.smem_bytes(5, 3, 3, 3, 7, 3) == (5 * 64 + 2 * 48 + 16 + 16
                                               + 16 + tables)


def test_pack_evict_table():
    """The eviction table's columns, 3 bits each in one 16-bit word, made
    once per set of column tensors and again after an in-place change;
    a value outside [0, 8) is refused."""
    tables = {k: torch.from_numpy(v.copy()) for k, v in
              engine.engine_tables(SimConfig()).items()}
    packed = es.pack_evict_table(tables)
    assert packed.dtype == torch.int16 and packed.shape == (es.EVICT_ENTRIES,)
    word = packed.to(torch.int32)
    for k, name in enumerate(es.EVICT_COLUMNS):
        assert torch.equal((word >> (3 * k)) & 7, tables[name]), name
    assert int(word.max()) < 1 << 12
    assert es.pack_evict_table(tables) is packed
    tables["il"][7] = 5
    again = es.pack_evict_table(tables)
    assert again is not packed and int(again[7]) >> 6 & 7 == 5
    for bad in (8, -1):
        tables["new_state"][3] = bad
        with pytest.raises(ValueError, match="new_state"):
            es.pack_evict_table(tables)


# ------------------------------------------------------------- workloads

@pytest.mark.parametrize("name", ref_traces.all_workload_names())
def test_build_workload_equals_reference(name):
    assert traces.all_workload_names() == ref_traces.all_workload_names()
    for seed in (0, 1):
        got = traces.build_workload(name, 2000, seed)
        want = ref_traces.build_workload(name, 2000, seed)
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
        for g, w in zip(got[1:6], want[1:6], strict=True):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert got[6] == want[6]


# ------------------------------------------------------ carry vs reference

def test_every_row_default_config(trace2):
    flags, params = rows_matrices(ROWS, {}, True)
    rflags, rparams = rows_matrices(ROWS, {}, False)
    assert np.array_equal(flags, rflags) and np.array_equal(params, rparams)
    want = ref_carry({}, rflags, rparams, trace2)
    assert_carry_equal(port_carry({}, flags, params, trace2), want)
    # chunks of 700 over 2,000 events (ragged last chunk) on one carry
    assert_carry_equal(port_carry({}, flags, params, trace2, 700), want,
                       "chunked")


def test_every_row_second_config(trace2):
    flags, params = rows_matrices(ROWS, CFG2, True)
    rflags, rparams = rows_matrices(ROWS, CFG2, False)
    assert np.array_equal(params, rparams)
    assert_carry_equal(port_carry(CFG2, flags, params, trace2),
                       ref_carry(CFG2, rflags, rparams, trace2))


VARIANTS = (
    # (base, overrides): counter init, sampling threshold, metadata sets
    ("dynamic", dict(counter_init=0)),
    ("dynamic", dict(counter_init=4095, sample_rate=0.5)),
    ("dynamic", dict(sample_rate=0.001)),
    ("explicit", dict(meta_sets=1)),
    ("explicit", dict(meta_sets=7)),
    ("cram", dict(lct_size=1, counter_init=17)),
)


@pytest.fixture
def variant_rows():
    """`schemes.variant` rows of the port (registered, and taken out of the
    registry afterwards) beside the reference's same records."""
    port_rows, ref_rows = [], []
    for i, (base, kw) in enumerate(VARIANTS):
        name = f"test-variant-{i}"
        port_rows.append(schemes.variant(base, name, **kw))
        ref_rows.append(dataclasses.replace(ref_schemes.get(base), name=name,
                                            **kw))
    yield port_rows, ref_rows
    for row in port_rows:
        schemes._REGISTRY.pop(row.name)


def test_variant_rows(trace2, variant_rows):
    port_rows, ref_rows = variant_rows
    flags, params = rows_matrices(port_rows, {}, True)
    rflags, rparams = rows_matrices(ref_rows, {}, False)
    assert np.array_equal(params, rparams)
    assert_carry_equal(port_carry({}, flags, params, trace2),
                       ref_carry({}, rflags, rparams, trace2))


def test_random_flag_points_small_config():
    """Seeded random (flags, params) rows, nonsensical combinations
    included, on a small LLC over 512 groups: every trace touches the last
    group and misses into empty victim ways."""
    rng = np.random.default_rng(20)
    n_rows, n_w, t = 12, 2, 600
    flags = (rng.random((n_rows, es.N_FLAGS)) < 0.5).astype(np.int32)
    params = np.zeros((n_rows, es.N_PARAMS), np.int32)
    params[:, es.PARAM_LCT_SIZE] = rng.choice([1, 7, 64, 512], n_rows)
    params[:, es.PARAM_SAMPLE_THRESH] = rng.integers(0, 1025, n_rows)
    params[:, es.PARAM_COUNTER_INIT] = rng.integers(0, 4096, n_rows)
    params[:, es.PARAM_META_SETS] = rng.choice([1, 16, 64], n_rows)
    n_groups = SMALL["n_groups"]
    trace = (rng.integers(0, n_groups * 4, (n_w, t)).astype(np.int32),
             rng.random((n_w, t)) < 0.4,
             rng.random((n_w, n_groups)) < 0.6,
             rng.random((n_w, n_groups)) < 0.6,
             rng.random((n_w, n_groups)) < 0.3)
    assert (trace[0] >> 2 == n_groups - 1).any()
    want = ref_carry(SMALL, flags, params, trace)
    assert_carry_equal(port_carry(SMALL, flags, params, trace), want)
    assert_carry_equal(port_carry(SMALL, flags, params, trace, 137), want,
                       "chunked")


def test_handmade_trace_last_group_and_empty_victims():
    """Group n_groups - 1 is written, packed and evicted by a stream of
    groups of its set; then misses land in sets whose victim way is empty
    (vg = -1, which the reference wraps to the last group)."""
    cfg = dict(llc_sets=4, llc_ways=2, n_groups=64)
    last = cfg["n_groups"] - 1
    same_set = [last - 4 * k for k in range(1, 6)]
    addrs = ([4 * last + lane for lane in range(4)]
             + [4 * g + lane for g in same_set for lane in (0, 1)]
             + [4 * last + 3, 4 * last]
             + [4 * g + 2 for g in (0, 1, 2)]       # sets 0-2: empty ways
             + [4 * last + 1] + [4 * g for g in same_set])
    a = np.asarray(addrs, np.int32)[None]
    wr = (np.arange(a.shape[1]) % 3 == 0)[None]
    ones = np.ones((1, cfg["n_groups"]), bool)
    trace = (a, wr, ones, ones, ones)
    flags, params = rows_matrices(ROWS, cfg, True)
    rflags, rparams = rows_matrices(ROWS, cfg, False)
    got = port_carry(cfg, flags, params, trace)
    assert_carry_equal(got, ref_carry(cfg, rflags, rparams, trace))
    mem = got[CARRY_NAMES.index("mem_state")]
    assert (mem[:, 0, last] != 0).any()   # the last group was packed


def test_cuda_wrapper_refuses_cpu_tensors():
    carry = engine.build_engine(SimConfig(**SMALL)).init_state(
        np.zeros((1, es.N_PARAMS), np.int32), device="cpu")
    z = torch.zeros((1, 4), dtype=torch.int32)
    fit = torch.zeros((1, 512), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        es.engine_scan_cuda(carry, z, z, z, z.bool(), fit, fit, fit, {}, {})


# ------------------------------------------------------ the sharded sweep

SHARD_ROWS = ("baseline", "cram", "explicit", "ideal")


@pytest.fixture(scope="module")
def trace4():
    return stacked(("libq", "pr_twi", "mix3", "mcf17"), 400, 0)


@pytest.fixture(scope="module")
def ref_sweep4(trace4):
    return ref_batchsim.sweep(SHARD_ROWS, *trace4, shard=False)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_sweep_over_cpu_devices(trace4, ref_sweep4, k, monkeypatch):
    """The workload axis in k shards, one engine run a shard: stats
    bit-exact with the single-device sweep and the reference's."""
    from repro_torch.core import batchsim

    calls = []
    launch = batchsim.launch_trace
    monkeypatch.setattr(batchsim, "launch_trace", lambda *a, **kw: (
        calls.append(kw["device"]), launch(*a, **kw))[1])
    got = batchsim.sweep(SHARD_ROWS, *trace4, device="cpu",
                         devices=["cpu"] * k)
    assert len(calls) == k
    assert np.array_equal(got, ref_sweep4)
    calls.clear()
    assert np.array_equal(batchsim.sweep(SHARD_ROWS, *trace4, device="cpu",
                                         shard=False, devices=["cpu"] * k),
                          ref_sweep4)
    assert len(calls) == 1


def test_sharded_sweep_falls_back_as_the_reference(trace4, ref_sweep4,
                                                   monkeypatch):
    """A workload count the devices do not divide, and a chunked sweep,
    run on one device; chunk_size with shard=True raises."""
    from repro_torch.core import batchsim

    calls = []
    launch = batchsim.launch_trace
    monkeypatch.setattr(batchsim, "launch_trace", lambda *a, **kw: (
        calls.append(kw["device"]), launch(*a, **kw))[1])
    three = tuple(x[:3] for x in trace4)
    got = batchsim.sweep(SHARD_ROWS, *three, device="cpu", shard=True,
                         devices=["cpu"] * 2)
    assert len(calls) == 1
    assert np.array_equal(got, ref_sweep4[:, :3])
    calls.clear()
    got = batchsim.sweep(SHARD_ROWS, *trace4, device="cpu", chunk_size=150,
                         devices=["cpu"] * 2)
    assert len(calls) == 1
    assert np.array_equal(got, ref_sweep4)
    with pytest.raises(ValueError, match="chunk_size and shard=True"):
        batchsim.sweep(SHARD_ROWS, *trace4, device="cpu", chunk_size=150,
                       shard=True, devices=["cpu"] * 2)
