"""The port's trace generators (`repro_torch.core.traces`) against the JAX
package's (`repro.core.traces`), and the invariant E1's shadow of the
LLC rests on, held with the plain version of the engine's step, on the
CPU.

`generate_trace` turns each batch of drawn segments into addresses with
array operations; the reference walks the segments one at a time.  The
draws are the same, so the arrays must be equal: at 200,000 events (many
batches, the last cut inside a segment), at 1, 1,023, 1,024 and 1,025
events, and at a length where a segment ends exactly on the last event.
"""

import zlib

import numpy as np
import pytest
import torch

from repro.core import traces as ref_traces
from repro_torch.core import engine, schemes, traces
from repro_torch.core.engine import SimConfig

torch.set_num_threads(1)


def _build(mod, name, n_events, seed):
    """build_workload's six arrays, or the error it raises (a mix at one
    event asks each part for none, and both generators refuse that)."""
    try:
        return mod.build_workload(name, n_events, seed)
    except ValueError as e:
        return str(e)


def assert_same_workload(name, n_events, seed):
    got = _build(traces, name, n_events, seed)
    want = _build(ref_traces, name, n_events, seed)
    if isinstance(want, str):
        assert got == want, (name, n_events, seed)
        return
    for g, w in zip(got[1:6], want[1:6], strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w), (name, n_events,
                                                             seed)
    assert got[6] == want[6]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["pr_twi", "libq", "mix3"])
def test_paper_length_traces_equal_reference(name, seed):
    assert_same_workload(name, 200_000, seed)


@pytest.mark.parametrize("n_events", [1, 1023, 1024, 1025])
def test_short_traces_equal_reference(n_events):
    for name in ref_traces.all_workload_names():
        for seed in (0, 1):
            assert_same_workload(name, n_events, seed)


def _first_batch_ends(spec, seed):
    """Where the segments of the first batch of draws end, for a trace of
    at most 8,192 events (its first batch is 1,024 segments long)."""
    rng = np.random.default_rng(seed ^ zlib.crc32(spec.name.encode()))
    lens = np.minimum(rng.geometric(1.0 / max(spec.seq_len, 1), size=1024),
                      256)
    lens = np.where(rng.random(1024) >= spec.p_seq, 1, lens)
    return np.cumsum(lens), lens


@pytest.mark.parametrize("name", ["libq", "pr_twi"])
def test_trace_ending_on_a_segment_end_equals_reference(name):
    """n_events equal to the end of a sequential segment longer than one
    line: the cut falls exactly after that segment's last address."""
    spec = traces.BY_NAME[name]
    for seed in (0, 1):
        ends, lens = _first_batch_ends(spec, seed)
        n_events = int(ends[(ends > 1025) & (ends <= 8192) & (lens > 1)][0])
        assert_same_workload(name, n_events, seed)
        # and one event short of it, a cut inside the same segment
        assert_same_workload(name, n_events - 1, seed)


def test_resident_groups_keep_their_mem_state():
    """The plain version, event by event over 300 events of libq and
    pr_twi for all 10 registry rows on a 16 x 2 LLC (every lane evicts
    often): mem_state changes only at the group evicted in that event,
    which was resident just before; and a resident group's mem_state
    stays what it was when the group was installed.  E1 keeps each
    resident group's state beside its tag on this invariant."""
    cfg = SimConfig(llc_sets=16, llc_ways=2)
    rows = schemes.names()
    built = [traces.build_workload(n, 300, 0) for n in ("libq", "pr_twi")]
    trace = engine.trace_tensors(
        cfg, *(np.stack([b[i] for b in built]) for i in range(1, 6)), "cpu")
    flags = torch.as_tensor(schemes.flags_matrix(rows))
    params = torch.as_tensor(schemes.params_matrix(rows, cfg))
    eng = engine.build_engine(cfg)
    carry = eng.init_state(params, 2, device="cpu")
    n_lanes = len(rows) * 2

    def resident():
        tags = carry[0].reshape(n_lanes, -1)
        return [set((t[t != 0] - 1).tolist()) for t in tags]

    installed = [{} for _ in range(n_lanes)]
    evictions = 0
    for e in range(trace[0].shape[1]):
        before, mem_before = resident(), carry[5].reshape(n_lanes, -1).clone()
        eng.run_chunk(carry, flags, params, trace[0][:, e:e + 1],
                      trace[1][:, e:e + 1], *trace[2:])
        after, mem = resident(), carry[5].reshape(n_lanes, -1)
        for lane in range(n_lanes):
            gone = before[lane] - after[lane]
            assert len(gone) <= 1
            evictions += len(gone)
            changed = set(torch.nonzero(mem[lane] != mem_before[lane])
                          .flatten().tolist())
            assert changed <= gone, (e, lane, changed, gone)
            for g in gone:
                del installed[lane][g]
            for g in after[lane] - before[lane]:
                installed[lane][g] = int(mem_before[lane, g])
            assert installed[lane].keys() == after[lane]
            for g, st in installed[lane].items():
                assert int(mem[lane, g]) == st, (e, lane, g)
    assert evictions > 1000
