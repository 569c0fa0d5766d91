"""Port parity for the spill tier: evict / wake / spill-direct admit /
step-time wake / prefetch / async encode drive the port's
`ServeLoop(device="cpu")` and the reference's
`repro.serving.ServeLoop(interpret=True)` with the same numpy streams.

Bit for bit, per step of each schedule: every spill payload (fit bits,
packed slots, base rows, raw lanes, tail page, hot bookkeeping, byte
counts), the scheduling records and counts, the cache state and host
masks, the ledger rows (spill crossings included) and the `KVStats`.
Attend outputs agree within atol = rtol = 1e-4 (float32, different
summation order).  Per-slot oracles are checked on settled layouts only:
pending migration is drained and dirty groups repacked first, on both.
The port's own wake-state guarantee is pinned too: a woken sequence's
physical state equals a twin loop's that never spilled."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.kv import synthetic_kv_stream
from repro.serving import ServeLoop as RefLoop
from repro_torch.bandwidth import Ledger
from repro_torch.serving import SPILL_LANES, ServeLoop

torch.set_num_threads(1)

PAGE, HKV, HD, HQ = 8, 2, 16, 4
MAX_PAGES = 8
TOL = dict(atol=1e-4, rtol=1e-4)
STATE_KEYS = ("pages", "slots", "slots_overflow", "strips", "packed_mask",
              "predictor", "counter", "markers", "traffic", "pred_hits",
              "pred_misses", "packed_n", "raw_n")
HOST_MASKS = ("tokens_b", "_dirty_b", "_uncounted_b", "_gate_b",
              "_applied_b", "_last_enabled")


def _stream(rng, t, compressible=True):
    k, v = synthetic_kv_stream(rng, 1, t, HKV, HD, compressible=compressible)
    return k[0], v[0]


def _loops(*, async_spill=False, **kw):
    kw = {"max_pages": MAX_PAGES, "page": PAGE, "n_kv": HKV,
          "head_dim": HD, **kw}
    return (RefLoop(interpret=True, async_spill=async_spill, **kw),
            ServeLoop(device="cpu", async_spill=async_spill, **kw))


def _arr(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_payload(want, got, ctx):
    for name in ("seq_id", "tokens", "packing", "counter", "raw_bytes",
                 "stored_bytes", "gate", "hot_packing"):
        assert getattr(want, name) == getattr(got, name), (ctx, name)
    for name in ("fit", "slots", "bases", "predictor", "uncounted"):
        assert np.array_equal(np.asarray(getattr(want, name)),
                              _arr(getattr(got, name))), (ctx, name)
    assert len(want.overflow) == len(got.overflow), ctx
    for a, b in zip(want.overflow, got.overflow, strict=True):
        assert np.array_equal(a, b.numpy()), (ctx, "overflow")
    assert (want.tail is None) == (got.tail is None), ctx
    if want.tail is not None:
        assert np.array_equal(want.tail, got.tail.numpy()), (ctx, "tail")


def _assert_same(ref, port, ctx, *, settle=True):
    """Everything observable, unsettled first; then settled, with both
    packages' per-slot views and the rebuild oracle."""
    ref.sync_ledger()
    port.sync_ledger()
    assert ref.ledger.as_dict() == port.ledger.as_dict(), ctx
    assert ref.counts == port.counts and ref.clock == port.clock, ctx
    assert ref._free == port._free, ctx
    recs = {sid: (r.slot, r.spilled, r.admitted_at, r.last_step)
            for sid, r in ref.seqs.items()}
    assert recs == {sid: (r.slot, r.spilled, r.admitted_at, r.last_step)
                    for sid, r in port.seqs.items()}, ctx
    rs, ps = ref.spill, port.spill
    assert rs.summary() == ps.summary(), ctx
    assert sorted(rs._store) == sorted(ps._store), ctx
    for sid in rs._store:
        _assert_payload(rs._store[sid], ps._store[sid], (ctx, sid))
    rc, pc = ref.cache, port.cache
    assert (rc.packing, rc.policy) == (pc.packing, pc.policy), ctx
    assert ref.suppressed_packing == port.suppressed_packing, ctx
    for _ in range(2 if settle else 1):
        for name in HOST_MASKS:
            assert np.array_equal(getattr(rc, name), getattr(pc, name)), \
                (ctx, name)
        for key in STATE_KEYS:
            assert np.array_equal(np.asarray(rc.state[key]),
                                  pc.state[key].numpy()), (ctx, key)
        assert asdict(rc.stats) == asdict(pc.stats), ctx
        if not settle:
            return
        for c in (rc, pc):
            c.drain_migration()
            c.repack(gate=c._gate_b)
    for slot in range(pc.batch):
        if not pc.tokens_b[slot]:
            continue
        for view in ("slot_physical_state", "slot_reference_state"):
            want = getattr(rc, view)(slot)
            got = getattr(pc, view)(slot)
            for key in want:
                assert np.array_equal(np.asarray(want[key]),
                                      got[key].numpy()), (ctx, view, key)
        if pc.policy != "off":
            # (under "off" a forced gate records applied=True over a raw
            # layout in both packages: ROADMAP.md, Queue 3)
            want = pc.slot_reference_state(slot)
            got = pc.slot_physical_state(slot)
            for key in want:
                assert torch.equal(got[key], want[key]), (ctx, key)


def _attend(ref, port, rng, ctx):
    act = ref.active_seqs()
    assert act == port.active_seqs(), ctx
    if not act:
        return
    q = {sid: rng.standard_normal((HQ, HD)).astype(np.float32)
         for sid in act}
    out_r, out_p = ref.attend(q), port.attend(q)
    for sid in act:
        np.testing.assert_allclose(out_p[sid].numpy(), np.asarray(out_r[sid]),
                                   err_msg=str(ctx), **TOL)


def _both(ref, port, name, *args, **kw):
    out_r = getattr(ref, name)(*args, **kw)
    out_p = getattr(port, name)(*args, **kw)
    return out_r, out_p


# ------------------------------------------------------- spill round trip

@pytest.mark.parametrize("async_spill", [False, True])
@pytest.mark.parametrize("spk", ["off", "pair", "quad"])
def test_spill_roundtrip_matches_reference(spk, async_spill):
    rng = np.random.default_rng(10)
    ref, port = _loops(slots=2, policy="static", packing="pair",
                       spill_packing=spk, async_spill=async_spill)
    k, v = _stream(rng, 6 * PAGE + 3)
    _both(ref, port, "admit", 0, k, v)
    port.cache.repack()
    ref.cache.repack()
    snap = {key: t.clone() for key, t in
            port.cache.slot_physical_state(0).items()}
    pages = port.cache.pages_view()[0].clone()
    _both(ref, port, "evict", 0)
    assert 0 in port.spill and port.seqs[0].spilled
    _assert_same(ref, port, (spk, "evicted"), settle=False)
    _both(ref, port, "wake", 0)
    slot = port.seqs[0].slot
    got = port.cache.slot_physical_state(slot)
    for key in snap:
        assert torch.equal(got[key], snap[key]), key
    assert torch.equal(port.cache.pages_view()[slot], pages)
    _attend(ref, port, rng, spk)
    _assert_same(ref, port, (spk, "woken"))
    s = port.spill.summary()
    assert s["spills"] == s["restores"] == 1 and s["held"] == 0


@pytest.mark.parametrize("spk,hot,policy,tokens,compressible,want_tail", [
    ("pair", "pair", "static", 4 * PAGE + 5, True, False),
    ("quad", "pair", "static", 2 * PAGE + 5, True, True),
    ("pair", "quad", "dynamic", 19, False, False),
])
def test_partial_page_roundtrip(spk, hot, policy, tokens, compressible,
                                want_tail):
    """Token counts off the page: the partial page must not poison its
    group (it crosses raw in `tail` beside a packed group), dead lanes are
    trimmed or ride as base replicas, and the counter and uncounted mask
    survive."""
    rng = np.random.default_rng(16)
    ref, port = _loops(slots=2, policy=policy, packing=hot,
                       spill_packing=spk)
    _both(ref, port, "admit", 7, *_stream(rng, tokens, compressible))
    ref.cache.repack()
    port.cache.repack()
    ctr = int(port.cache.state["counter"][0])
    unc = port.cache._uncounted_b[0].copy()
    _both(ref, port, "evict", 7)
    p = port.spill._store[7]
    assert (p.tail is not None) == want_tail
    assert bool(p.fit.any()) == compressible
    _assert_same(ref, port, (spk, tokens, "evicted"), settle=False)
    _both(ref, port, "wake", 7)
    slot = port.seqs[7].slot
    assert int(port.cache.state["counter"][slot]) == ctr
    assert (port.cache._uncounted_b[slot] == unc).all()
    _assert_same(ref, port, (spk, tokens, "woken"))


def test_spill_savings_order_matches_reference():
    """quad moves fewer link bytes than pair, pair fewer than raw; "off"
    costs the fit bits only."""
    rng = np.random.default_rng(11)
    k, v = _stream(rng, 8 * PAGE)
    stored = {}
    for spk in ("off", "pair", "quad"):
        ref, port = _loops(slots=1, policy="static", spill_packing=spk)
        _both(ref, port, "admit", 0, k, v)
        _both(ref, port, "evict", 0)
        _assert_same(ref, port, spk, settle=False)
        stored[spk] = port.spill.stored_bytes
        assert port.spill.raw_bytes == 8 * port.cache.slot_bytes
    assert stored["quad"] < stored["pair"] < stored["off"]
    assert stored["off"] <= port.spill.raw_bytes * 1.01


def test_restore_decodes_under_the_payloads_packing():
    rng = np.random.default_rng(17)
    ref, port = _loops(slots=1, policy="static", spill_packing="quad")
    _both(ref, port, "admit", 0, *_stream(rng, 8 * PAGE))
    _both(ref, port, "evict", 0)
    port.spill.flush()
    assert port.spill._store[0].packing == "quad"
    for loop in (ref, port):
        loop.spill.packing, loop.spill.lanes = "pair", SPILL_LANES["pair"]
    _both(ref, port, "wake", 0)
    _assert_same(ref, port, "woken under quad")


@pytest.mark.parametrize("hot,other", [("pair", "quad"), ("quad", "pair")])
def test_hot_packing_switch_while_cold(hot, other):
    """The hot cache migrates to the other packing while a sequence is
    cold: restore resets its predictor and uncounted masks and lays it
    under the current target."""
    rng = np.random.default_rng(18)
    ref, port = _loops(slots=2, policy="dynamic", packing=hot,
                       spill_packing="pair")
    for sid in (0, 1):
        _both(ref, port, "prefill", sid, *_stream(rng, 3 * PAGE + 2))
    _both(ref, port, "step_all", {0: _stream(rng, 1), 1: _stream(rng, 1)})
    _both(ref, port, "evict", 0)
    assert ref.migrate_to(packing=other) == port.migrate_to(packing=other)
    _both(ref, port, "step_all", {1: _stream(rng, 1)})
    _both(ref, port, "wake", 0)
    slot = port.seqs[0].slot
    assert port.cache.packing == other
    assert not port.cache._uncounted_b[slot].any()
    _attend(ref, port, rng, "after switch")
    _assert_same(ref, port, (hot, other))


def test_roundtrip_with_pending_dirty_appends():
    rng = np.random.default_rng(13)
    ref, port = _loops(slots=1, policy="static", spill_packing="quad")
    _both(ref, port, "admit", 0, *_stream(rng, 2 * PAGE + 3))
    _both(ref, port, "step", {0: _stream(rng, 1)})
    k, v = _stream(rng, 2)
    ref.cache.append_slot(0, k, v)            # dirty again, no repack
    port.cache.append_slot(0, k, v)
    _both(ref, port, "evict", 0)
    _both(ref, port, "wake", 0)
    _assert_same(ref, port, "pending dirty")


@pytest.mark.parametrize("async_spill", [False, True])
def test_capacity_bound_and_retire_while_cold(async_spill):
    rng = np.random.default_rng(14)
    ref, port = _loops(slots=2, policy="static", spill_pages=4,
                       async_spill=async_spill)
    for sid in (0, 1):
        _both(ref, port, "admit", sid, *_stream(rng, 4 * PAGE))
    _both(ref, port, "evict", 0)              # 4 pages held == capacity
    for loop in (ref, port):
        with pytest.raises(RuntimeError, match="spill store full"):
            loop.evict(1)
    _both(ref, port, "retire", 0)             # retired while cold: dropped
    assert 0 not in port.spill and len(port.spill) == 0
    _both(ref, port, "evict", 1)
    assert 1 in port.spill
    _assert_same(ref, port, "capacity")


# ------------------------------------------------------------- scheduling

def test_admit_beyond_pool_spills_incoming_coldest():
    """A prompt admitted into a full pool whose recency key sorts below
    every resident goes straight to the spill tier; waking it equals a
    hot-lane prefill; once anything has stepped, a new admit evicts."""
    rng = np.random.default_rng(22)
    ref, port = _loops(slots=2, policy="static", packing="pair",
                       spill_packing="quad")
    for sid in (10, 11):
        _both(ref, port, "admit", sid, *_stream(rng, 2 * PAGE))
    kp, vp = _stream(rng, 3 * PAGE + 3)
    rec_r, rec = _both(ref, port, "prefill", 3, kp, vp)
    assert rec.spilled and rec.slot == -1 and 3 in port.spill
    assert port.counts["spilled_direct"] == 1 and port.counts["evicted"] == 0
    _assert_same(ref, port, "spilled direct", settle=False)
    twin = ServeLoop(slots=1, max_pages=MAX_PAGES, page=PAGE, n_kv=HKV,
                     head_dim=HD, policy="static", device="cpu")
    twin.prefill(3, kp, vp)
    _both(ref, port, "retire", 10)
    _both(ref, port, "wake", 3)
    port.cache.repack()
    got = port.cache.slot_physical_state(port.seqs[3].slot)
    want = twin.cache.slot_physical_state(0)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert int(port.cache.state["counter"][port.seqs[3].slot]) == int(
        twin.cache.state["counter"][0])
    _both(ref, port, "step", {11: _stream(rng, 1)})
    _, rec2 = _both(ref, port, "admit", 20, *_stream(rng, PAGE))
    assert not rec2.spilled and port.counts["evicted"] == 1
    _assert_same(ref, port, "after admit")


def test_step_never_evicts_a_step_named_sequence():
    rng = np.random.default_rng(3)
    ref, port = _loops(slots=2, policy="static")
    for sid in range(4):
        _both(ref, port, "admit", sid, *_stream(rng, PAGE))
    assert port.spilled_seqs() == [0, 1] and port.active_seqs() == [2, 3]
    _both(ref, port, "step", {0: _stream(rng, 1), 2: _stream(rng, 1)})
    assert not port.seqs[2].spilled and port.seqs[3].spilled
    for loop in (ref, port):
        with pytest.raises(ValueError, match="step names 3"):
            loop.step({s: _stream(rng, 1) for s in (0, 2, 3)})
    kvs = {s: _stream(rng, 1) for s in (0, 2, 3)}
    assert _both(ref, port, "step_all", kvs)[1].keys() == {0, 2, 3}
    _attend(ref, port, rng, "waves")
    _assert_same(ref, port, "waves")


def test_wake_into_half_migrated_cache():
    rng = np.random.default_rng(8)
    ref, port = _loops(slots=2, policy="static")
    for sid in (0, 1):
        _both(ref, port, "admit", sid, *_stream(rng, 4 * PAGE))
    for _ in range(2):
        _both(ref, port, "step", {s: _stream(rng, 1) for s in (0, 1)})
    _both(ref, port, "evict", 0)              # settled under gate=True
    for loop in (ref, port):
        loop.cache.set_gate_override(False)   # target moves while cold
    _both(ref, port, "step", {1: _stream(rng, 1)})
    assert port.cache.migration_status()["migrating"]
    _both(ref, port, "wake", 0)
    assert port.cache.migration_pending()[port.seqs[0].slot].any()
    _assert_same(ref, port, "just woken", settle=False)
    steps = 0
    while port.cache.migration_pending().any():
        _both(ref, port, "step", {s: _stream(rng, 1) for s in (0, 1)})
        steps += 1
        assert steps < 100
    assert ref.cache.migration_status() == port.cache.migration_status()
    assert not port.cache.state["packed_mask"].any()
    _assert_same(ref, port, "converged")


def test_scripted_interleaving_admit_step_evict_wake_flip():
    rng = np.random.default_rng(9)
    ref, port = _loops(slots=2, policy="static")
    nxt = [0]

    def admit(t, fused):
        k, v = _stream(rng, t)
        _both(ref, port, "prefill" if fused else "admit", nxt[0], k, v)
        nxt[0] += 1

    def step():
        act = port.active_seqs()
        if act:
            _both(ref, port, "step", {s: _stream(rng, 1) for s in act})

    def flip(value):
        for loop in (ref, port):
            loop.cache.set_gate_override(value)

    script = [lambda: admit(2 * PAGE, False), step,
              lambda: admit(3 * PAGE + 3, True), step,
              lambda: flip(False), step,
              lambda: admit(3 * PAGE + 3, True), step, step,
              lambda: _both(ref, port, "wake", port.spilled_seqs()[0]),
              step, lambda: flip(True),
              lambda: admit(3 * PAGE + 3, True), step, step,
              lambda: _both(ref, port, "evict", port.active_seqs()[0]),
              step, lambda: flip(None), step, step, step]
    for i, op in enumerate(script):
        op()
        if i % 4 == 3:
            _assert_same(ref, port, ("script", i), settle=False)
    _attend(ref, port, rng, "script end")
    _assert_same(ref, port, "script end")


def _random_schedule(seed, async_spill, n_ops=18):
    """Random admit / prefill / step_all (oversubscribed) / evict / wake /
    retire / gate flip / packing switch / attend, the pool oversubscribed
    by up to two sequences."""
    rng = np.random.default_rng(seed)
    policy = ["static", "dynamic", "off"][seed % 3]
    packing = ["pair", "quad"][seed % 2]
    spk = ["quad", "pair", "off"][seed % 3]
    ref, port = _loops(slots=2, policy=policy, packing=packing,
                       spill_packing=spk, async_spill=async_spill)
    cap = MAX_PAGES * PAGE
    fed, nxt = {}, 0
    for op_no in range(n_ops):
        live = sorted(port.seqs)
        op = rng.choice(["admit", "admit", "step", "step", "step", "evict",
                         "wake", "retire", "flip", "migrate", "attend"])
        ctx = (seed, async_spill, op_no, op)
        if op == "admit" and len(live) < port.n_slots + 2:
            k, v = _stream(rng, int(rng.integers(1, 3 * PAGE)),
                           bool(rng.random() < 0.7))
            _both(ref, port, "prefill" if rng.random() < 0.5 else "admit",
                  nxt, k, v)
            fed[nxt] = k.shape[0]
            nxt += 1
        elif op == "step" and live:
            ids = [s for s in live if fed[s] < cap]
            if rng.random() < 0.5:
                ids = [s for s in ids if rng.random() < 0.7] or ids[:1]
            kvs = {s: _stream(rng, 1, bool(rng.random() < 0.8))
                   for s in ids}
            if kvs:
                _both(ref, port, "step_all", kvs)
                for s in kvs:
                    fed[s] += 1
        elif op == "evict" and port.active_seqs():
            _both(ref, port, "evict", int(rng.choice(port.active_seqs())))
        elif op == "wake" and port.spilled_seqs():
            _both(ref, port, "wake", int(rng.choice(port.spilled_seqs())))
        elif op == "retire" and live:
            sid = int(rng.choice(live))
            _both(ref, port, "retire", sid)
            fed.pop(sid)
        elif op == "flip":
            value = [True, False, None][int(rng.integers(3))]
            for loop in (ref, port):
                loop.cache.set_gate_override(value)
        elif op == "migrate":
            other = "quad" if port.cache.packing == "pair" else "pair"
            assert ref.migrate_to(packing=other) == port.migrate_to(
                packing=other), ctx
        elif op == "attend":
            _attend(ref, port, rng, ctx)
        if op_no % 4 == 3:
            _assert_same(ref, port, ctx, settle=False)
    _attend(ref, port, rng, (seed, "end"))
    _assert_same(ref, port, (seed, async_spill, "end"))
    return port


@pytest.mark.parametrize("async_spill", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_random_schedule_matches_reference(seed, async_spill):
    port = _random_schedule(seed, async_spill)
    assert port.counts["admitted"] > 0


def test_async_books_the_same_ledger_rows_as_sync(monkeypatch):
    """The async pipeline books exactly the ledger calls of the sync one,
    one spill row per crossing (an evict books when it is collected, so
    only the order may differ)."""
    calls: list = []
    orig = Ledger.record

    def counting(self, *a, **kw):
        calls.append((a, tuple(sorted(kw.items()))))
        return orig(self, *a, **kw)

    monkeypatch.setattr(Ledger, "record", counting)
    runs = {}
    for async_spill in (False, True):
        calls.clear()
        rng = np.random.default_rng(4)
        loop = ServeLoop(slots=2, max_pages=MAX_PAGES, page=PAGE, n_kv=HKV,
                         head_dim=HD, policy="static", packing="pair",
                         spill_packing="quad", async_spill=async_spill,
                         device="cpu")
        for sid in range(5):
            loop.prefill(sid, *_stream(rng, 2 * PAGE + sid))
        for _ in range(3):
            loop.step_all({sid: _stream(rng, 1) for sid in range(5)})
        loop.retire(0)
        loop.sync_ledger()
        spill_rows = [c for c in calls if c[0] == (4,)]
        n = loop.counts
        assert len(spill_rows) == (n["evicted"] + n["woken"]
                                   + n["spilled_direct"])
        runs[async_spill] = (sorted(calls, key=repr),
                             loop.ledger.as_dict())
    assert runs[False] == runs[True]


@pytest.mark.parametrize("hot,spk", [("pair", "quad"), ("quad", "pair")])
def test_churn_wakes_equal_never_spilled_twin(hot, spk):
    """Eight sequences in four slots, every step naming all eight, so
    every step evicts and wakes: each sequence, woken at the end, is
    bit-identical to a twin loop with eight slots that never spilled; the
    spill rows equal evicts + wakes + spill-direct admits."""
    rng = np.random.default_rng(7)
    n_seq, prompt, steps = 8, 3 * PAGE + 1, 6
    total = prompt + steps
    k, v = synthetic_kv_stream(rng, n_seq, total, HKV, HD)
    ki, vi = synthetic_kv_stream(rng, n_seq, total, HKV, HD,
                                 compressible=False)
    k[6], v[6] = ki[6], vi[6]
    kw = dict(max_pages=-(-total // PAGE), page=PAGE, n_kv=HKV, head_dim=HD,
              policy="static", packing=hot, device="cpu")
    loop = ServeLoop(slots=4, spill_packing=spk, **kw)
    twin = ServeLoop(slots=n_seq, **kw)
    for i in range(n_seq):
        for lp in (loop, twin):
            lp.prefill(i, k[i, :prompt], v[i, :prompt])
    for t in range(prompt, total):
        kvs = {i: (k[i, t:t + 1], v[i, t:t + 1]) for i in range(n_seq)}
        loop.step_all(kvs)
        twin.step_all(kvs)
        q = {i: rng.standard_normal((HQ, HD)).astype(np.float32)
             for i in loop.active_seqs()}
        got, want = loop.attend(q), twin.attend(q)
        for i in q:
            torch.testing.assert_close(got[i], want[i], **TOL)
    twin.cache.repack()
    for i in range(n_seq):
        loop.wake(i)
        loop.cache.repack()
        got = loop.cache.slot_physical_state(loop.seqs[i].slot)
        want = twin.cache.slot_physical_state(twin.seqs[i].slot)
        for key in want:
            assert torch.equal(got[key], want[key]), (i, key)
    s = loop.summary()
    n = loop.counts
    assert n["evicted"] >= 4 * steps and n["woken"] >= 4 * steps
    rows = loop.ledger.total("spill", consumer="kv")
    assert rows["count"] == n["evicted"] + n["woken"] + n["spilled_direct"]
    assert s["spill_tier"]["saving"] > 0
