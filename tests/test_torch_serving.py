"""Port parity for the serve tier: random admit / prefill / step_all /
attend / retire schedules with gate flips and packing migrations drive the
port's `ServeLoop(device="cpu")` and the reference's
`repro.serving.ServeLoop(interpret=True)` with the same numpy streams.

Per slot, bit for bit: the physical layout, the §VI counters, the LLP
predictor, the token counts, the ledger rows after `sync_ledger` and the
`KVStats`.  Attend outputs agree within atol = rtol = 1e-4 (float32,
different summation order).  Layouts are compared only once settled:
pending migration is drained and dirty groups repacked first, on both.
There is no evict here: `slots >= live` throughout (the spill tier's
schedules are in tests/test_torch_spill.py)."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.kv import synthetic_kv_stream
from repro.serving import ServeLoop as RefLoop
from repro_torch.serving import ServeLoop, shard_kv_attend

torch.set_num_threads(1)

PAGE, HKV, HD, HQ = 4, 2, 8, 4
SLOTS, MAX_PAGES = 3, 8
TOL = dict(atol=1e-4, rtol=1e-4)
STATE_KEYS = ("pages", "slots", "slots_overflow", "strips", "packed_mask",
              "predictor", "counter", "markers")


def _loops(policy, packing, fused=True):
    kw = dict(slots=SLOTS, max_pages=MAX_PAGES, page=PAGE, n_kv=HKV,
              head_dim=HD, policy=policy, packing=packing, fused=fused)
    return (RefLoop(interpret=True, async_spill=False, **kw),
            ServeLoop(device="cpu", **kw))


def _settle(loop):
    loop.cache.drain_migration()
    loop.cache.repack(gate=loop.cache._gate_b)


def _assert_same(ref, port, ctx):
    _settle(ref)
    _settle(port)
    rc, pc = ref.cache, port.cache
    assert not pc.migration_pending().any(), ctx
    assert np.array_equal(rc.tokens_b, pc.tokens_b), ctx
    assert rc.packing == pc.packing, ctx
    for key in STATE_KEYS:
        assert np.array_equal(np.asarray(rc.state[key]),
                              pc.state[key].numpy()), (ctx, key)
    for slot in range(SLOTS):
        if rc.tokens_b[slot]:
            for view in ("slot_physical_state", "slot_reference_state"):
                want = getattr(rc, view)(slot)
                got = getattr(pc, view)(slot)
                for key in want:
                    assert np.array_equal(np.asarray(want[key]),
                                          got[key].numpy()), (ctx, view, key)
    ref.sync_ledger()
    port.sync_ledger()
    assert ref.ledger.as_dict() == port.ledger.as_dict(), ctx
    assert asdict(rc.stats) == asdict(pc.stats), ctx


def _stream(rng, t, compressible):
    k, v = synthetic_kv_stream(rng, 1, t, HKV, HD, compressible=compressible)
    return k[0], v[0]


def _attend(ref, port, rng, ctx):
    live = sorted(ref.seqs)
    if not live:
        return
    q = {sid: rng.standard_normal((HQ, HD)).astype(np.float32)
         for sid in live}
    st = port.cache.state
    booked = {k: st[k].clone() for k in ("traffic", "pred_hits",
                                         "pred_misses")}
    out_r = ref.attend(q)
    out_p = port.attend(q)
    for sid in live:
        np.testing.assert_allclose(out_p[sid].numpy(), np.asarray(out_r[sid]),
                                   err_msg=str(ctx), **TOL)
    # the unsharded attend is the cache's own, charging nothing
    rows = torch.zeros((SLOTS, HQ, HD))
    for sid in live:
        rows[port.seqs[sid].slot] = torch.from_numpy(q[sid])
    got = shard_kv_attend(port.cache, rows, shard=False)
    assert torch.equal(got, port.cache.attend(rows, account=False)), ctx
    for sid in live:
        assert torch.equal(got[port.seqs[sid].slot], out_p[sid]), ctx
    for key, was in booked.items():
        assert torch.equal(st[key], was), (ctx, key)


def _run_schedule(seed, policy, packing, n_ops=14):
    rng = np.random.default_rng(seed)
    ref, port = _loops(policy, packing)
    cap = MAX_PAGES * PAGE
    fed, next_id = {}, 0
    for op_no in range(n_ops):
        op = rng.choice(["admit", "step", "step", "attend", "retire",
                         "flip", "migrate"])
        ctx = (seed, op_no, op)
        if op == "admit" and len(ref.seqs) < SLOTS:
            t = int(rng.integers(1, 3 * PAGE))
            k, v = _stream(rng, t, bool(rng.random() < 0.7))
            ref.prefill(next_id, k, v)
            port.prefill(next_id, k, v)
            fed[next_id] = t
            next_id += 1
        elif op == "step" and ref.seqs:
            ids = [s for s in sorted(ref.seqs) if fed[s] < cap]
            kvs = {s: _stream(rng, 1, bool(rng.random() < 0.8))
                   for s in ids}
            if kvs:
                ref.step_all(kvs)
                port.step_all(kvs)
                for s in kvs:
                    fed[s] += 1
        elif op == "attend":
            _attend(ref, port, rng, ctx)
        elif op == "retire" and ref.seqs:
            sid = int(rng.choice(sorted(ref.seqs)))
            ref.retire(sid)
            port.retire(sid)
            fed.pop(sid)
        elif op == "flip":
            value = [True, False, None][int(rng.integers(3))]
            ref.cache.set_gate_override(value)
            port.cache.set_gate_override(value)
        elif op == "migrate":
            other = "quad" if ref.cache.packing == "pair" else "pair"
            assert ref.migrate_to(packing=other) == port.migrate_to(
                packing=other)
        if op_no % 5 == 4:
            _assert_same(ref, port, ctx)
    _attend(ref, port, rng, (seed, "end"))
    _assert_same(ref, port, (seed, "end"))
    assert ref.summary().keys() == port.summary().keys()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("packing", ["pair", "quad"])
def test_random_schedule_matches_reference(seed, packing):
    policy = ["dynamic", "static", "off", "dynamic"][seed]
    _run_schedule(seed, policy, packing)


def _drive(loop, rng_seed, steps=6):
    rng = np.random.default_rng(rng_seed)
    for sid in range(2):
        loop.prefill(sid, *_stream(rng, 5 + 3 * sid, True))
    for step in range(steps):
        loop.step_all({sid: _stream(rng, 1, step % 3 != 0)
                       for sid in range(2)})
        if step == 2:
            loop.cache.set_gate_override(False)
    return loop


@pytest.mark.parametrize("packing", ["pair", "quad"])
def test_megastep_equals_unfused_sequence(packing):
    kw = dict(slots=2, max_pages=MAX_PAGES, page=PAGE, n_kv=HKV,
              head_dim=HD, packing=packing, device="cpu")
    fused = _drive(ServeLoop(fused=True, **kw), 3)
    unfused = _drive(ServeLoop(fused=False, **kw), 3)
    for key in STATE_KEYS + ("traffic", "pred_hits", "pred_misses",
                             "packed_n", "raw_n"):
        assert torch.equal(fused.cache.state[key],
                           unfused.cache.state[key]), key


@pytest.mark.parametrize("packing", ["pair", "quad"])
@pytest.mark.parametrize("t", [1, PAGE + 1, 3 * PAGE])
def test_prefill_equals_token_replay(packing, t):
    kw = dict(slots=2, max_pages=MAX_PAGES, page=PAGE, n_kv=HKV,
              head_dim=HD, packing=packing, device="cpu")
    rng = np.random.default_rng(t)
    k, v = _stream(rng, t, True)
    bulk = ServeLoop(**kw)
    bulk.prefill(0, k, v)
    replay = ServeLoop(**kw)
    replay.admit(0, k, v)                     # append_slot, not prefill
    replay.cache.repack(gate=replay.cache._gate_b)
    for key in ("pages", "slots", "slots_overflow", "strips", "packed_mask",
                "counter"):
        assert torch.equal(bulk.cache.state[key],
                           replay.cache.state[key]), key
    q = {0: rng.standard_normal((HQ, HD)).astype(np.float32)}
    assert torch.equal(bulk.attend(q)[0], replay.attend(q)[0])


@pytest.mark.parametrize("packing", ["pair", "quad"])
@pytest.mark.parametrize("policy", ["dynamic", "off"])
def test_uniform_cache_matches_reference(packing, policy):
    """CRAMKVCache (uniform appends): incremental state, from-scratch
    rebuild, attend with accounting, the oracle attend, stats and the
    ledger saving, against the reference."""
    from repro.kv import CRAMKVCache as RefCache
    from repro_torch.kv import CRAMKVCache

    kw = dict(max_pages=MAX_PAGES, page=PAGE, n_kv=HKV, head_dim=HD,
              batch=2, policy=policy, packing=packing)
    ref, port = RefCache(interpret=True, **kw), CRAMKVCache(device="cpu",
                                                            **kw)
    rng = np.random.default_rng(9)
    for i, t in enumerate((2 * PAGE + 1, 1, PAGE)):
        k, v = synthetic_kv_stream(rng, 2, t, HKV, HD,
                                   compressible=i % 2 == 0)
        ref.append(k, v)
        port.append(k, v)
        q = rng.standard_normal((2, HQ, HD)).astype(np.float32)
        np.testing.assert_allclose(port.attend(q).numpy(),
                                   np.asarray(ref.attend(q)), **TOL)
        np.testing.assert_allclose(port.attend_ref(q).numpy(),
                                   np.asarray(ref.attend_ref(q)), **TOL)
        for key in STATE_KEYS:
            assert np.array_equal(np.asarray(ref.state[key]),
                                  port.state[key].numpy()), (i, key)
        for view in ("reference_rebuild", "active_state"):
            want, got = getattr(ref, view)(), getattr(port, view)()
            for key in want:
                assert np.array_equal(np.asarray(want[key]),
                                      got[key].numpy()), (i, view, key)
    assert asdict(ref.stats) == asdict(port.stats)
    assert ref.saving() == port.saving()
    assert ref.ledger.as_dict() == port.ledger.as_dict()
