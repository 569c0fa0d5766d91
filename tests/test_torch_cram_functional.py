"""The port's exact functional model (`repro_torch.core.cram.CRAMSystem`) and
its parts (LLP, DynamicController, GroupLLC, LIT) against the JAX
package's, on the CPU.

Seeded op sequences — reads and writes of zero, repeated, delta and random
lines, some with a tail planted on their slot's pair or quad marker so
they must be stored inverted — drive both systems under every policy,
with compress_clean on and off and both LIT overflow policies.  Every
read, the stats, the memory image, the LIT, the markers' generation, the
LLP and the §VI counter must be equal.
"""

import zlib

import numpy as np
import pytest
import torch

from repro.compression import gate as ref_gate
from repro.compression import predictor as ref_predictor
from repro.core import cram as ref_cram
from repro.core import lit as ref_lit
from repro.core import llc as ref_llc
from repro_torch.compression import gate, predictor
from repro_torch.core import cram, lit, llc

torch.set_num_threads(1)


def _line(kind, rng):
    if kind == 0:
        return np.zeros(64, np.uint8)
    if kind == 1:
        return np.tile(rng.integers(0, 256, 8).astype(np.uint8), 8)
    if kind == 2:
        base = rng.integers(0, 2**30, dtype=np.int64)
        return (base + rng.integers(-50, 50, 16)).astype("<i4").view(
            np.uint8).copy()
    return rng.integers(0, 256, 64).astype(np.uint8)


def _ops(seed, n_lines, n_ops):
    """(addr, is_write, kind, plant, line seed) per op: `plant` puts the
    slot's pair (1) or quad (2) marker in the line's last four bytes."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, n_lines)), bool(rng.random() < 0.5),
             int(rng.integers(0, 4)), int(rng.choice(3, p=[0.9, 0.05, 0.05])),
             int(rng.integers(0, 2**31)))
            for _ in range(n_ops)]


def _drive(system, ops):
    reads = []
    for addr, is_write, kind, plant, line_seed in ops:
        if is_write:
            data = _line(kind, np.random.default_rng(line_seed))
            if plant:
                marker = (system.spec.marker2 if plant == 1
                          else system.spec.marker4)(addr)
                data[-4:] = np.frombuffer(marker, np.uint8)
            system.access(addr, is_write=True, data=data)
        else:
            reads.append(system.access(addr))
    system.flush()
    reads.extend(system.access(a) for a in range(0, system.n_lines, 7))
    return reads


def _state(system):
    return {"stats": system.stats.as_dict(),
            "total": system.total_mem_accesses(),
            "lit": (sorted(system.lit.entries),
                    sorted(system.lit.overflow_map), system.lit.overflowed,
                    system.lit.overflow_events, system.lit.extra_accesses),
            "generation": system.spec.generation,
            "llp": (system.llp.lct.tolist(), system.llp.predictions,
                    system.llp.correct),
            "counters": system.dyn.counters.tolist()}


@pytest.mark.parametrize("policy", ["static", "dynamic", "uncompressed"])
@pytest.mark.parametrize("compress_clean", [True, False])
@pytest.mark.parametrize("overflow", ["memory_mapped", "regenerate"])
def test_cram_system_equals_reference(policy, compress_clean, overflow):
    seed = zlib.crc32(f"{policy}/{compress_clean}/{overflow}".encode())
    kw = dict(n_lines=256, llc_sets=8, llc_ways=2, policy=policy,
              compress_clean=compress_clean, lit_capacity=2,
              lit_overflow=overflow)
    ops = _ops(seed, 256, 500)
    got_sys, want_sys = cram.CRAMSystem(**kw), ref_cram.CRAMSystem(**kw)
    got, want = _drive(got_sys, ops), _drive(want_sys, ops)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g, w)
    assert _state(got_sys) == _state(want_sys)
    assert np.array_equal(got_sys.mem, want_sys.mem)
    assert got_sys.stats.extra_probes == want_sys.stats.extra_probes


def test_cram_system_collisions_overflow_the_lit():
    """A run that plants many markers: the LIT overflows (memory-mapped) or
    the markers are re-keyed (regenerate) in both packages alike."""
    for overflow in ("memory_mapped", "regenerate"):
        kw = dict(n_lines=128, llc_sets=4, llc_ways=2, policy="static",
                  lit_capacity=1, lit_overflow=overflow)
        ops = [(a, True, 3, 1 + a % 2, a) for a in range(3, 60, 4)]
        ops += [(a, False, 0, 0, 0) for a in range(3, 60, 4)]
        got_sys, want_sys = cram.CRAMSystem(**kw), ref_cram.CRAMSystem(**kw)
        got, want = _drive(got_sys, ops), _drive(want_sys, ops)
        for g, w in zip(got, want, strict=True):
            assert np.array_equal(g, w)
        assert _state(got_sys) == _state(want_sys)
        assert np.array_equal(got_sys.mem, want_sys.mem)
        if overflow == "memory_mapped":
            assert got_sys.lit.overflowed
        else:
            assert got_sys.spec.generation > 0


def test_llp_equals_reference():
    rng = np.random.default_rng(3)
    for n in (512, 64, 7):
        got, want = predictor.LLP(n), ref_predictor.LLP(n)
        for _ in range(300):
            addr = int(rng.integers(0, 1 << 20))
            assert got.predict_level(addr) == want.predict_level(addr)
            lvl = int(rng.integers(0, 3))
            got.update(addr, lvl)
            want.update(addr, lvl)
            ok = bool(rng.random() < 0.7)
            got.record_outcome(ok)
            want.record_outcome(ok)
        assert np.array_equal(got.lct, want.lct)
        assert (got.accuracy, got.storage_bytes) == (want.accuracy,
                                                     want.storage_bytes)
    pages = np.arange(0, 1 << 14, 37)
    assert np.array_equal(predictor.lct_index(pages),
                          ref_predictor.lct_index(pages))
    assert predictor.HASH_MULT == ref_predictor.HASH_MULT
    lct = np.zeros(512, np.int8)
    want = ref_predictor.llp_update(lct, 12345, 2, np)
    assert np.array_equal(predictor.llp_update(lct, 12345, 2, np), want)
    got_t = predictor.llp_update(torch.from_numpy(lct), 12345, 2, torch)
    assert np.array_equal(got_t.numpy(), want) and not lct.any()
    assert predictor.llp_predict(want, 12345, np) == \
        ref_predictor.llp_predict(want, 12345, np)


def test_probe_count_table_equals_reference():
    from repro.compression import layouts as ref_layouts
    from repro_torch.compression import layouts
    assert np.array_equal(
        predictor.probe_count_table(layouts.get_layout("group4")),
        ref_predictor.probe_count_table(ref_layouts.get_layout("group4")))


def test_dynamic_controller_and_sampling_equal_reference():
    rng = np.random.default_rng(4)
    got, want = gate.DynamicController(2), ref_gate.DynamicController(2)
    for _ in range(3000):
        core, n = int(rng.integers(0, 2)), int(rng.integers(1, 40))
        if rng.random() < 0.55:
            got.cost(n, core)
            want.cost(n, core)
        else:
            got.benefit(n, core)
            want.benefit(n, core)
        assert got.enabled(core) == want.enabled(core)
    assert np.array_equal(got.counters, want.counters)
    assert got.storage_bytes == want.storage_bytes
    sets = np.arange(4096)
    for rate in (0.01, 0.08, 0.5):
        assert np.array_equal(gate.is_sampled_set(sets, 4096, rate),
                              ref_gate.is_sampled_set(sets, 4096, rate))
    assert (gate.SAMPLE_RATE, gate.COUNTER_INIT) == (ref_gate.SAMPLE_RATE,
                                                     ref_gate.COUNTER_INIT)


def test_group_llc_equals_reference():
    rng = np.random.default_rng(6)
    got, want = llc.GroupLLC(8, 2), ref_llc.GroupLLC(8, 2)
    victims = []
    for _ in range(400):
        group = int(rng.integers(0, 64))
        mask = int(rng.integers(1, 16))
        pair = []
        for mod, cache in ((llc, got), (ref_llc, want)):
            e = mod.GroupEntry(group=group, valid_mask=mask,
                               pf_mask=mask & 0b1010)
            v = cache.install(e)
            pair.append(None if v is None else (v.group, v.valid_mask,
                                                v.pf_mask, v.lru))
        assert pair[0] == pair[1]
        victims.append(pair[0])
        assert got.is_sampled(group) == want.is_sampled(group)
    assert any(victims)
    snap = [[(e.group, e.valid_mask, e.pf_mask, e.lru) for e in s]
            for s in got.sets]
    assert snap == [[(e.group, e.valid_mask, e.pf_mask, e.lru) for e in s]
                    for s in want.sets]
    assert got.capacity_lines == want.capacity_lines


def test_lit_equals_reference():
    rng = np.random.default_rng(7)
    got, want = lit.LIT(capacity=3), ref_lit.LIT(capacity=3)
    for _ in range(500):
        a, op = int(rng.integers(0, 20)), int(rng.integers(0, 4))
        if op == 0:
            got.insert(a)
            want.insert(a)
        elif op == 1:
            got.remove(a)
            want.remove(a)
        elif op == 2:
            assert got.contains(a) == want.contains(a)
        else:
            assert got.would_overflow(a) == want.would_overflow(a)
    assert (got.entries, got.overflow_map, got.overflowed,
            got.overflow_events, got.extra_accesses, got.storage_bytes) == (
        want.entries, want.overflow_map, want.overflowed,
        want.overflow_events, want.extra_accesses, want.storage_bytes)
    assert lit.years_to_overflow() == ref_lit.years_to_overflow()
