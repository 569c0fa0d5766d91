"""Port parity for the AutoTuner, the §VI gate helpers it runs on, the
spill-crossing ledger adapter and the per-tier policy of the serve tier.

The same numpy inputs go through `repro.bandwidth` / `repro.serving`
(interpret mode) and `repro_torch.bandwidth` / `repro_torch.serving`
(`device="cpu"`): every decision (choice, preferred pick, expected bytes
per page, basis), every §VI counter after every observation window and
every ledger row are equal.  The reference's golden decision tables are
pinned on the port as well.  The fit-rate probe truncates float32 words
to their bf16 high halves where the cache rounds; the probe tests use
samples whose low 16 bits are not zero, so the difference shows."""

import numpy as np
import pytest
import torch

from repro import bandwidth as rb
from repro.compression import gate as r_gate
from repro.kv import CRAMKVCache as RefCache
from repro.serving import ServeLoop as RefLoop
from repro_torch import bandwidth as tb
from repro_torch.bandwidth import EV_READ, AutoTuner, Ledger
from repro_torch.bandwidth.autotune import (
    kv_expected_bytes_per_page,
    kv_spill_bytes_per_page,
    probe_kv_fit_rates,
)
from repro_torch.compression import codecs as codecs_reg
from repro_torch.compression import gate
from repro_torch.kv import CRAMKVCache, synthetic_kv_stream
from repro_torch.serving import ServeLoop

torch.set_num_threads(1)

PAGE, HKV, HD = 8, 1, 32


def _choice(c) -> dict:
    return c.as_dict()


def test_counter_helpers_match_reference():
    for c in (0, 5, gate.ENABLE_THRESHOLD - 1, gate.ENABLE_THRESHOLD,
              gate.COUNTER_INIT, gate.COUNTER_MAX):
        for cost, benefit in ((0, 0), (256, 0), (0, 256), (7, 3)):
            want = r_gate.counter_step(np.int64(c), cost, benefit, np)
            got = gate.counter_step(np.int64(c), cost, benefit, np)
            assert int(got) == int(want) and got.dtype == want.dtype
        assert gate.counter_enabled(c) == r_gate.counter_enabled(c)
    for name in ("COUNTER_BITS", "COUNTER_MAX", "ENABLE_THRESHOLD",
                 "COUNTER_INIT"):
        assert getattr(gate, name) == getattr(r_gate, name), name


def test_autotuner_golden_decision_table():
    tuner, ref = AutoTuner(), rb.AutoTuner()
    table = {(0.0, 0.0): "off", (0.95, 0.0): "pair", (0.9, 0.85): "quad",
             (0.1, 0.05): "off"}
    for (p, q), want in table.items():
        got = tuner.choose_kv_packing({"pair": p, "quad": q})
        assert got.choice == want, (p, q, got)
        assert _choice(got) == _choice(ref.choose_kv_packing(
            {"pair": p, "quad": q}))
        again = tuner.choose_kv_packing({"pair": p, "quad": q})
        assert got == again


def test_autotuner_per_tier_golden_decision_table():
    tuner, ref = AutoTuner(), rb.AutoTuner()
    table = {(0.0, 0.0): ("off", "off"), (0.15, 0.15): ("off", "quad"),
             (0.95, 0.0): ("pair", "pair"), (0.9, 0.85): ("quad", "quad")}
    for (p, q), (want_hot, want_spill) in table.items():
        fits = {"pair": p, "quad": q}
        hot = tuner.choose_kv_packing(fits, strip_bytes=1 / 8)
        spl = tuner.choose_kv_packing(fits, page=8, tier="spill")
        assert (hot.choice, spl.choice) == (want_hot, want_spill), (p, q)
        assert hot.target == "kv" and spl.target == "kv-spill"
        assert _choice(hot) == _choice(ref.choose_kv_packing(
            fits, strip_bytes=1 / 8))
        assert _choice(spl) == _choice(ref.choose_kv_packing(
            fits, page=8, tier="spill"))
    for fr in (0.0, 0.3, 0.5, 1.0):
        for lanes in (2, 4):
            assert kv_spill_bytes_per_page(fr, lanes, 4096.0, 16) == \
                rb.kv_spill_bytes_per_page(fr, lanes, 4096.0, 16)
            assert kv_expected_bytes_per_page(fr, lanes, 4096.0, 520.0) == \
                rb.kv_expected_bytes_per_page(fr, lanes, 4096.0, 520.0)
    assert kv_spill_bytes_per_page(0.5, 4, page=8) < \
        kv_expected_bytes_per_page(0.5, 4, strip_bytes=1 / 8)


def test_autotuner_ckpt_codec_probe_matches_reference():
    tuner, ref = AutoTuner(), rb.AutoTuner()
    rng = np.random.default_rng(0)
    zeros = np.zeros((64, 64), np.uint8)
    rand = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    small = (rng.integers(0, 4, (5000, 16)).astype(np.uint32)
             .view(np.uint8))                 # strided past max_lines
    for lines in (zeros, rand, small):
        assert _choice(tuner.choose_ckpt_codec(lines)) == _choice(
            ref.choose_ckpt_codec(lines))
    assert tuner.choose_ckpt_codec(zeros).choice in ("bdi", "hybrid", "fpc")
    assert tuner.choose_ckpt_codec(rand).choice == "raw"
    assert set(tuner.choose_ckpt_codec(zeros).expected) == set(
        codecs_reg.codec_names("line64"))
    tables = {"tensors": {"weights": {"bdi": 1.5, "fpc": 1.2}}}
    got = AutoTuner(tables=tables).choose_ckpt_codec(tensor_class="weights")
    want = rb.AutoTuner(tables=tables).choose_ckpt_codec(
        tensor_class="weights")
    assert _choice(got) == _choice(want) and got.choice == "bdi"


def test_grad_codec_and_combined_choose_match_reference():
    rng = np.random.default_rng(1)
    k, v = synthetic_kv_stream(rng, 1, 8 * PAGE, HKV, HD, scale=2e-4)
    telemetry = {"kv_sample_k": k, "kv_sample_v": v, "page": PAGE,
                 "ckpt_samples": {"weights": np.zeros((8, 64), np.uint8)},
                 "grad_rel_err": 0.01}
    for t in (telemetry, {"kv_fit_rates": {"pair": 0.9, "quad": 0.2},
                          "grad_rel_err": 0.2}):
        got = AutoTuner().choose(t)
        want = rb.AutoTuner().choose(t)
        assert got.keys() == want.keys()
        for key in got:
            assert _choice(got[key]) == _choice(want[key]), key
    for err in (0.0, 0.05, 0.5):
        assert _choice(AutoTuner().choose_grad_codec(err)) == _choice(
            rb.AutoTuner().choose_grad_codec(err))


def test_ledger_gate_disables_and_reenables_like_reference():
    """observe() judges each window since the key's last observation: the
    counter after every window equals the reference's."""
    tuner, ref = AutoTuner(), rb.AutoTuner()
    led, led_r = Ledger("kv"), rb.Ledger("kv")
    windows = ([(100, 50)] * 50 + [(0, 0)] + [(100, 130)] * 30
               + [(100, 40)] * 30)
    history = []
    for raw, comp in windows:
        if raw:
            led.record(EV_READ, raw=raw, compressed=comp)
            led_r.record(rb.EV_READ, raw=raw, compressed=comp)
        c = tuner.observe(led, key="kv", consumer="kv")
        assert c == ref.observe(led_r, key="kv", consumer="kv")
        assert tuner.gate_enabled("kv") == ref.gate_enabled("kv")
        history.append(tuner.gate_enabled("kv"))
    assert history[50] and not history[80] and history[-1]
    assert led.saving(EV_READ) > 0


@pytest.mark.parametrize("scale,compressible", [(2e-4, True), (2e-3, True),
                                                (None, False)])
def test_probe_truncates_like_reference(scale, compressible):
    """float32 samples with non-zero low halves: the probe's truncated
    bf16 patterns give the reference's fit rates, and the compressible
    sample is built so that rounding to nearest would give other ones."""
    rng = np.random.default_rng(5)
    kw = {} if scale is None else {"scale": scale}
    k, v = synthetic_kv_stream(rng, 2, 16 * PAGE, HKV, HD,
                               compressible=compressible, **kw)
    assert (k.view(np.uint32) & 0xFFFF).any()
    if compressible:
        # element 0 of every token sits just below a bf16 midpoint over
        # one shared high half H; one token per quad group sits just above
        # the midpoint over H + 7.  Truncated, its delta is 7 and quads
        # fit; rounded to nearest it is 8 and they do not.
        hi = k.view(np.uint32)[0, 0, 0, 0] & 0xFFFF0000
        k.view(np.uint32)[:, :, :, 0] = hi | 0x7FFF
        k.view(np.uint32)[:, 1::4 * PAGE, :, 0] = (hi + (7 << 16)) | 0x8001
    got = probe_kv_fit_rates(k, v, page=PAGE)
    assert got == rb.probe_kv_fit_rates(k, v, page=PAGE)
    assert got == probe_kv_fit_rates(torch.from_numpy(k),
                                     torch.from_numpy(v), page=PAGE)
    if not compressible:
        assert got == {"pair": 0.0, "quad": 0.0}
        return
    assert got["pair"] > 0.9 and got["quad"] > 0.9
    k_rounded = torch.from_numpy(k).to(torch.bfloat16).float().numpy()
    rounded = probe_kv_fit_rates(k_rounded, v, page=PAGE)
    assert rounded["pair"] == got["pair"] and rounded["quad"] == 0.0


def test_kv_cache_auto_constructor_matches_reference():
    rng = np.random.default_rng(0)
    tight = synthetic_kv_stream(rng, 1, 6 * PAGE, HKV, HD, scale=2e-4)
    noise = synthetic_kv_stream(rng, 1, 6 * PAGE, HKV, HD,
                                compressible=False)
    kw = dict(max_pages=8, page=PAGE, n_kv=HKV, head_dim=HD)
    for sample, want in ((tight, ("pair", "quad")), (noise, ("off",))):
        cache, choice = CRAMKVCache.auto(AutoTuner(), *sample, device="cpu",
                                         **kw)
        ref, ref_choice = RefCache.auto(rb.AutoTuner(), *sample,
                                        interpret=True, **kw)
        assert _choice(choice) == _choice(ref_choice)
        assert choice.choice in want
        assert (cache.policy, cache.packing) == (ref.policy, ref.packing)
        assert cache.n_pairs == ref.n_pairs
    cache, _ = CRAMKVCache.auto(AutoTuner(), *tight, device="cpu", **kw)
    ref, _ = RefCache.auto(rb.AutoTuner(), *tight, interpret=True, **kw)
    cache.append(*tight)
    ref.append(*tight)
    bw, bw_r = cache.account_step(), ref.account_step()
    assert int(bw["raw_bytes"]) == int(bw_r["raw_bytes"])
    assert int(bw["cram_bytes"]) == int(bw_r["cram_bytes"])
    assert bw["cram_bytes"] < bw["raw_bytes"]
    assert cache.n_active_pairs == ref.n_active_pairs
    assert cache.host_stats == cache._host_stats
    for name in ("pack_attempts", "pack_calls", "pack_pairs_processed",
                 "pack_skipped_dynamic"):
        assert getattr(cache.host_stats, name) == getattr(ref.host_stats,
                                                          name), name


def test_kv_cache_auto_runs_the_dynamic_gate():
    rng = np.random.default_rng(0)
    tight = synthetic_kv_stream(rng, 1, 4 * PAGE, HKV, HD, scale=2e-4)
    noise = synthetic_kv_stream(rng, 1, 16 * PAGE, HKV, HD,
                                compressible=False)
    kw = dict(max_pages=32, page=PAGE, n_kv=HKV, head_dim=HD,
              counter_init=gate.ENABLE_THRESHOLD + 1)
    cache, choice = CRAMKVCache.auto(AutoTuner(), *tight, device="cpu", **kw)
    ref, _ = RefCache.auto(rb.AutoTuner(), *tight, interpret=True, **kw)
    assert cache.policy == "auto" and choice.choice != "off"
    for stream in (tight, noise):
        for c in (cache, ref):
            c.append(*stream)
            c.repack()
        assert np.array_equal(cache.enabled(), ref.enabled())
        assert int(cache.state["counter"][0]) == int(ref.state["counter"][0])
    assert not cache.enabled().any()


def test_kv_spill_event_books_exactly_one_row_per_crossing():
    led, led_r = Ledger(), rb.Ledger()
    for direction in ("evict", "restore"):
        assert tb.kv_spill_event(led, raw=1000, compressed=400,
                                 direction=direction) == \
            rb.kv_spill_event(led_r, raw=1000, compressed=400,
                              direction=direction)
    assert led.as_dict() == led_r.as_dict()
    for tc in ("kv-evict", "kv-restore"):
        t = led.total("spill", consumer="kv", tensor_class=tc)
        assert (t["raw_bytes"], t["compressed_bytes"], t["count"]) == \
            (1000, 400, 1)
    assert led.saving("spill", consumer="kv") == pytest.approx(0.6)
    with pytest.raises(AssertionError):
        tb.kv_spill_event(led, raw=1, compressed=1, direction="sideways")


@pytest.mark.parametrize("async_spill", [False, True])
def test_serve_loop_spill_crossings_hit_the_shared_ledger(async_spill):
    rng = np.random.default_rng(0)
    k, v = synthetic_kv_stream(rng, 1, 6 * PAGE, HKV, HD)
    kw = dict(slots=2, max_pages=8, page=PAGE, n_kv=HKV, head_dim=HD,
              policy="static", spill_packing="quad", async_spill=async_spill)
    led, led_r = Ledger("serve"), rb.Ledger("serve")
    loop = ServeLoop(ledger=led, device="cpu", **kw)
    ref = RefLoop(ledger=led_r, interpret=True, **kw)
    for lp in (loop, ref):
        lp.admit(0, k[0], v[0])
        lp.evict(0)
        lp.spill.flush()
    ev = led.total("spill", consumer="kv", tensor_class="kv-evict")
    assert ev["count"] == 1 and 0 < ev["compressed_bytes"] < ev["raw_bytes"]
    for lp in (loop, ref):
        lp.wake(0)
    rs = led.total("spill", consumer="kv", tensor_class="kv-restore")
    assert rs["count"] == 1
    assert (rs["raw_bytes"], rs["compressed_bytes"]) == \
        (ev["raw_bytes"], ev["compressed_bytes"])
    assert led.total("spill", consumer="kv")["count"] == 2
    loop.sync_ledger()
    ref.sync_ledger()
    assert led.as_dict() == led_r.as_dict()


def _auto_pair(tuner_setup=None, k=None, v=None, **kw):
    tuners = [AutoTuner(), rb.AutoTuner()]
    if tuner_setup:
        for t in tuners:
            tuner_setup(t)
    kw = {"slots": 2, "max_pages": 8, "page": PAGE, "n_kv": HKV,
          "head_dim": HD, **kw}
    loop, ch = ServeLoop.auto(tuners[0], k, v, device="cpu", **kw)
    ref, ch_r = RefLoop.auto(tuners[1], k, v, interpret=True, **kw)
    assert {t: _choice(c) for t, c in ch.items()} == \
        {t: _choice(c) for t, c in ch_r.items()}
    return loop, ch, ref


def test_serve_loop_auto_picks_per_tier_packings():
    rng = np.random.default_rng(15)
    k, v = synthetic_kv_stream(rng, 1, 8 * PAGE, HKV, HD, scale=2e-4)
    loop, choices, ref = _auto_pair(k=k, v=v)
    assert choices["hot"].target == "kv"
    assert choices["spill"].target == "kv-spill"
    assert loop.spill.packing == choices["spill"].choice != "off"
    for lp in (loop, ref):
        lp.admit(0, k[0], v[0])
        lp.evict(0)
        lp.wake(0)
    assert loop.observe_tiers() == ref.observe_tiers()
    assert set(loop.observe_tiers()) == {"kv-hot", "kv-spill"}
    assert loop.summary() == ref.summary()
    noise = synthetic_kv_stream(rng, 1, 8 * PAGE, HKV, HD,
                                compressible=False)
    _, off, _ = _auto_pair(k=noise[0], v=noise[1])
    assert off["hot"].choice == "off" and off["spill"].choice == "off"


def _one(rng):
    k, v = synthetic_kv_stream(rng, 1, 1, HKV, HD)
    return k[0], v[0]


def test_suppressed_packing_reenables_into_tuner_pick():
    """auto with the hot gate forced off records the tuner's pick; a
    re-enabling window migrates the live cache to it, as the reference
    does, step for step."""
    rng = np.random.default_rng(11)
    k, v = synthetic_kv_stream(rng, 1, 8 * PAGE, HKV, HD, scale=2e-4)

    def harm(t):
        t._counters["kv-hot"] = 0
    loop, ch, ref = _auto_pair(harm, k=k, v=v)
    assert ch["hot"].choice == "off"
    assert ch["hot"].preferred in ("pair", "quad")
    assert loop.suppressed_packing == ch["hot"].preferred
    assert loop.cache.policy == "off"
    for lp in (loop, ref):
        lp.admit(0, k[0, :4 * PAGE], v[0, :4 * PAGE])
    kv = _one(rng)
    for lp in (loop, ref):
        lp.step({0: kv})
        lp.tuner._counters["kv-hot"] = gate.COUNTER_MAX
    assert loop.observe_tiers() == ref.observe_tiers()
    assert loop.cache.policy == "auto"
    assert loop.cache.packing == ch["hot"].preferred
    assert loop.suppressed_packing is None
    assert loop.cache.migration_status() == ref.cache.migration_status()
    for i in range(20):
        kv = _one(rng)
        for lp in (loop, ref):
            lp.step({0: kv})
        assert loop.cache.migration_status() == \
            ref.cache.migration_status(), i
        if not loop.cache.migration_pending().any():
            break
    assert not loop.cache.migration_pending().any()
    for key in ("slots", "slots_overflow", "strips", "packed_mask",
                "counter"):
        assert np.array_equal(np.asarray(ref.cache.state[key]),
                              loop.cache.state[key].numpy()), key
    assert loop.summary() == ref.summary()


def test_gate_disable_records_suppressed_packing():
    rng = np.random.default_rng(12)
    k, v = synthetic_kv_stream(rng, 1, 8 * PAGE, HKV, HD, scale=2e-4)
    loop, _, ref = _auto_pair(k=k, v=v)
    assert loop.cache.policy != "off"
    running = loop.cache.packing
    kv = _one(rng)
    for lp in (loop, ref):
        lp.admit(0, k[0, :4 * PAGE], v[0, :4 * PAGE])
        lp.step({0: kv})
        lp.tuner._counters["kv-hot"] = 0
    assert loop.observe_tiers() == ref.observe_tiers()
    assert loop.cache.policy == "off"
    assert loop.suppressed_packing == running
    assert loop.summary()["hot_packing"] == "off"
    assert loop.summary() == ref.summary()


def test_observe_tiers_windows_match_reference():
    """Per-tier windows over a churning loop: hot judged on the read rows,
    spill on the spill rows, each window since the last one; counters and
    the live gate equal the reference's after every window."""
    rng = np.random.default_rng(21)
    k, v = synthetic_kv_stream(rng, 1, 8 * PAGE, HKV, HD, scale=2e-4)
    loop, _, ref = _auto_pair(k=k, v=v, slots=1)
    assert loop.observe_tiers() == ref.observe_tiers()   # empty windows
    streams = {sid: synthetic_kv_stream(rng, 1, 2 * PAGE + sid, HKV, HD,
                                        compressible=sid != 1)
               for sid in range(3)}
    for sid, (ks, vs) in streams.items():
        for lp in (loop, ref):
            lp.prefill(sid, ks[0], vs[0])
    for _ in range(4):
        kvs = {sid: _one(rng) for sid in range(3)}
        for lp in (loop, ref):
            lp.step_all(kvs)
        obs = loop.observe_tiers()
        assert obs == ref.observe_tiers()
        assert loop.tuner._counters == ref.tuner._counters
        assert (loop.cache.policy, loop.cache.packing) == (
            ref.cache.policy, ref.cache.packing)
    assert loop.counts["evicted"] > 0 and loop.counts["woken"] > 0
    assert loop.ledger.as_dict() == ref.ledger.as_dict()
