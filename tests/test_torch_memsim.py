"""The port's simulator front-ends (`repro_torch.core.memsim`, `batchsim`)
and the engine's ledger adapters against the JAX reference, on the CPU.

`tests/golden/engine_stats.json` (the reference's pinned stats: six paper
schemes x libq / pr_twi / mix3, 12,000 events, seed 1) is reproduced
through the plain version of E1; `simulate` whole and chunked,
`run_workload` and `sweep_workloads` give the reference's summaries field
for field (floats exactly); `engine_traffic` / `engine_breakdown` give the
reference's rows.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from repro.bandwidth import adapters as ref_adapters
from repro.core import batchsim as ref_batchsim
from repro.core import memsim as ref_memsim
from repro.core import schemes as ref_schemes
from repro.core import traces as ref_traces
from repro_torch.bandwidth import engine_breakdown, engine_traffic
from repro_torch.core import batchsim, memsim, schemes
from repro_torch.core.engine import STAT_NAMES, SimConfig

torch.set_num_threads(1)

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "engine_stats.json").read_text())
GOLDEN_NAMES = ("libq", "pr_twi", "mix3")
# the reference's built-in rows, in registration order (a test of the
# reference may register more rows in its process-wide registry)
BUILTIN_ROWS = (*ref_schemes.BASE_SCHEMES, "cram-nollp",
                *ref_schemes.LCT_SENSITIVITY)


def test_golden_through_the_plain_version():
    _, _, *trace = batchsim.stack_workloads(GOLDEN_NAMES, GOLDEN["n_events"],
                                            GOLDEN["seed"])
    assert tuple(GOLDEN["stat_names"]) == STAT_NAMES
    stats = batchsim.sweep(memsim.SCHEMES, *trace, device="cpu")
    assert stats.shape == (6, 3, 15) and stats.dtype == np.int32
    for si, sch in enumerate(memsim.SCHEMES):
        for wi, name in enumerate(GOLDEN_NAMES):
            assert stats[si, wi].tolist() == GOLDEN["stats"][sch][name], (
                sch, name)


@pytest.fixture(scope="module")
def libq():
    return ref_traces.build_workload("libq", 1500, 3)


@pytest.mark.parametrize("scheme,chunk", [("dynamic", None),
                                          ("dynamic", 333),
                                          ("explicit", 1024)])
def test_simulate_equals_reference(libq, scheme, chunk):
    _, a, w, pab, pcd, pq, _ = libq
    got = memsim.simulate(scheme, a, w, pab, pcd, pq, chunk_size=chunk,
                          device="cpu")
    want = ref_memsim.simulate(scheme, a, w, pab, pcd, pq, chunk_size=chunk)
    assert got.__dict__ == want.__dict__
    assert got.bandwidth_breakdown() == want.bandwidth_breakdown()


def test_run_workload_equals_reference():
    kw = dict(schemes=("cram", "nextline"), n_events=1000, seed=2)
    got = memsim.run_workload("mcf17", **kw, device="cpu")
    want = ref_memsim.run_workload("mcf17", **kw)
    assert got == want
    assert set(got["schemes"]) == {"cram", "nextline"}


def test_sweep_workloads_equals_reference_every_row():
    rows = BUILTIN_ROWS
    kw = dict(names=["pr_twi", "mix2"], schemes=rows, n_events=2000,
              seed=0)
    got = batchsim.sweep_workloads(**kw, device="cpu")
    want = ref_batchsim.sweep_workloads(**kw, shard=False)
    assert got == want
    for name in kw["names"]:
        for sch, summary in got[name]["schemes"].items():
            assert engine_breakdown(summary["traffic"]) == \
                ref_adapters.engine_breakdown(summary["traffic"]), sch


def test_engine_traffic_equals_reference():
    rng = np.random.default_rng(5)
    for _ in range(20):
        vals = rng.integers(0, 1000, len(STAT_NAMES))
        vals[STAT_NAMES.index("read_probes")] += vals[
            STAT_NAMES.index("demand_reads")]
        vals[rng.integers(0, len(STAT_NAMES))] = 0
        stats = dict(zip(STAT_NAMES, (int(v) for v in vals), strict=True))
        got = engine_traffic(stats).as_dict()
        assert got == ref_adapters.engine_traffic(stats).as_dict()
        assert engine_breakdown(got) == ref_adapters.engine_breakdown(got)
        assert engine_breakdown(got, consumer="other")["total"] == 0


def test_scheme_registry_equals_reference():
    assert schemes.names() == BUILTIN_ROWS
    assert schemes.BASE_SCHEMES == ref_schemes.BASE_SCHEMES
    assert schemes.LCT_SENSITIVITY == ref_schemes.LCT_SENSITIVITY
    cfg = SimConfig(meta_sets=32)
    from repro.core.engine import SimConfig as RefConfig
    assert np.array_equal(schemes.flags_matrix(schemes.names()),
                          ref_schemes.flags_matrix(BUILTIN_ROWS))
    assert np.array_equal(
        schemes.params_matrix(schemes.names(), cfg),
        ref_schemes.params_matrix(BUILTIN_ROWS, RefConfig(meta_sets=32)))
    assert np.array_equal(batchsim.scheme_flags(["cram", "ideal"]),
                          ref_batchsim.scheme_flags(["cram", "ideal"]))
    with pytest.raises(KeyError, match="unknown scheme"):
        schemes.flags_matrix(["nope"])
    with pytest.raises(ValueError, match="lct_size"):
        schemes.Scheme("bad", lct_size=0)
    with pytest.raises(ValueError, match="meta_sets"):
        schemes.Scheme("bad", meta_sets=65).params(SimConfig())


def test_sweep_refusals(libq):
    _, a, w, pab, pcd, pq, _ = libq
    trace = tuple(x[None] for x in (a, w, pab, pcd, pq))
    with pytest.raises(ValueError, match="chunk_size and shard=True"):
        batchsim.sweep(["cram"], *trace, chunk_size=100, shard=True,
                       device="cpu")
    bad = trace[0].copy()
    bad[0, 5] = 4 * SimConfig().n_groups
    with pytest.raises(ValueError, match="trace addresses"):
        batchsim.sweep(["cram"], bad, *trace[1:], device="cpu")
    with pytest.raises(ValueError, match="fit bitmaps"):
        batchsim.sweep(["cram"], *trace[:2], pab[None, :100], *trace[3:],
                       device="cpu")
    # shard=True on one device runs the single-device path
    one = batchsim.sweep(["cram"], trace[0][:, :300], trace[1][:, :300],
                         *trace[2:], shard=True, device="cpu")
    two = batchsim.sweep(["cram"], trace[0][:, :300], trace[1][:, :300],
                         *trace[2:], shard=False, chunk_size=128,
                         device="cpu")
    assert np.array_equal(one, two)
