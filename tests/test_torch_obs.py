"""The port's spans and counters (`repro_torch.obs`) on the CPU: no-ops
with no profiler, the span tree under one, the aggregates, the host
crossing counters, the spill worker's spans, the benchmark's readers of
them, and the byte ledger past 2^31 in int64."""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch import configs, obs
from repro_torch.bandwidth import Ledger, device_record, device_totals
from repro_torch.bandwidth.adapters import kv_read_device, kv_repack_device
from repro_torch.bandwidth.ledger import EV_READ
from repro_torch.models import build
from repro_torch.serving import ServeLoop

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAGE, HKV, HD, HQ = 8, 2, 16, 4
CACHE_LEN = 128                    # two attention chunks at smoke size
SERVE_SPANS = {        # span -> the spans it opens inside, on the serve path
    "serve.step": None, "serve.attend": None, "serve.admit": None,
    "serve.retire": None, "serve.evict": None, "serve.wake": None,
    "cache.megastep": "serve.step", "cache.append": "cache.megastep",
    "cache.lay_window": ("cache.megastep", "cache.prefill"),
    "cache.book": "cache.megastep",
    "cache.prefill": "serve.admit", "cache.repack": "serve.attend",
    "cache.k3": "serve.attend",
    "spill.encode": "serve.evict", "spill.decode": "serve.wake",
    "host.sync": None,
}
MODEL_SPANS = {
    "dense": {"model.decode_step": None, "attn.decode": "model.decode_step"},
    "moe": {"model.decode_step": None, "attn.decode": "model.decode_step",
            "moe.apply": "model.decode_step",
            "moe.route": "moe.apply", "moe.dispatch": "moe.apply",
            "moe.experts": "moe.apply", "moe.combine": "moe.apply"},
}


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


def _rows(rng, t):
    """k, v (t, HKV, HD) float32 CPU tensors of a compressible stream."""
    base = rng.standard_normal((1, HKV, HD)).astype(np.float32)
    k, v = (torch.from_numpy(base + 1e-3 * rng.standard_normal(
        (t, HKV, HD)).astype(np.float32)) for _ in range(2))
    return k, v


def _loop(**kw):
    kw = {"slots": 2, "max_pages": 8, "page": PAGE, "n_kv": HKV,
          "head_dim": HD, "device": "cpu", **kw}
    return ServeLoop(**kw)


def _tier_step(loop, rng, sids):
    loop.step_all({s: _rows(rng, 1) for s in sids})
    q = torch.from_numpy(rng.standard_normal((len(sids), HQ, HD))
                         .astype(np.float32))
    return loop.attend({s: q[i] for i, s in enumerate(sids)})


def _model(kind):
    if kind == "dense":        # grouped queries: two query heads a KV head
        cfg = dataclasses.replace(configs.get_smoke("phi4_mini_3_8b"),
                                  n_kv_heads=2)
    else:
        cfg = configs.get_smoke("olmoe_1b_7b")
    model = build(cfg, device="cpu", seed=0)
    return model, model.init_cache(2, CACHE_LEN)


def _decode(model, cache, steps):
    tok = torch.zeros((2, 1), dtype=torch.int64)
    for i in range(steps):
        tok = model.decode_step(tok, cache, i).argmax(-1)[:, None]


def _annotations(prof) -> dict[str, list]:
    out: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def _assert_tree(found: dict, tree: dict) -> None:
    """Every span of `tree` was opened, each inside a span of one of its
    parents' names."""
    for name, parents in tree.items():
        assert name in found, (name, sorted(found))
        if parents is None:
            continue
        parents = (parents,) if isinstance(parents, str) else parents
        outer = [iv for p in parents for iv in found.get(p, [])]
        for a, b in found[name]:
            assert any(pa <= a and b <= pb for pa, pb in outer), (
                f"{name} at {a} opens outside every {parents}")


def _serve_churn(rng):
    """A tier run that opens every serve span: two slots, three sessions,
    so the third's admission evicts one and a step wakes it."""
    loop = _loop(async_spill=False)
    loop.prefill(0, *_rows(rng, 20))
    loop.prefill(1, *_rows(rng, 12))
    _tier_step(loop, rng, [0, 1])
    loop.prefill(2, *_rows(rng, 9))      # evicts the coldest (0)
    loop.retire(1)
    _tier_step(loop, rng, [0, 2])        # wakes 0
    loop.cache.stats                     # noqa: B018  (a device read)
    loop.sync_ledger()
    return loop


# ----------------------------------------------------------------- off
def test_no_profiler_records_nothing():
    rng = np.random.default_rng(0)
    assert obs.span("serve.step") is obs.span("serve.step")
    _serve_churn(rng)
    model, cache = _model("moe")
    _decode(model, cache, 2)
    obs.count("host.h2d", 3)
    assert obs.snapshot() == {"spans": {}, "counts": {}}


# ------------------------------------------------------------------ on
@pytest.mark.parametrize("path", ["serve", "dense", "moe"])
def test_spans_nest_as_the_layers(path):
    rng = np.random.default_rng(1)
    if path != "serve":
        model, cache = _model(path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if path == "serve":
            _serve_churn(rng)
        else:
            _decode(model, cache, 2)
    found = _annotations(prof)
    tree = SERVE_SPANS if path == "serve" else MODEL_SPANS[path]
    _assert_tree(found, tree)
    assert set(found) == set(tree)


def test_snapshot_counts_a_step_of_each_layer():
    rng = np.random.default_rng(2)
    loop = _loop()
    loop.prefill(0, *_rows(rng, 20))
    loop.prefill(1, *_rows(rng, 12))
    model, cache = _model("dense")
    steps, layers = 3, model.config.n_layers
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(steps):
            _tier_step(loop, rng, [0, 1])
        _decode(model, cache, steps)
    snap = obs.snapshot()["spans"]
    want = {"serve.step": steps, "cache.megastep": steps,
            "cache.append": steps, "cache.lay_window": steps,
            "cache.book": steps, "serve.attend": steps,
            "cache.repack": steps, "cache.k3": steps,
            "model.decode_step": steps, "attn.decode": steps * layers,
            "host.sync": 7 * steps}      # the staged copies (below)
    assert {k: snap[k]["n"] for k in want} == want
    assert set(snap) == set(want)
    for name, agg in snap.items():
        assert 0 <= agg["self_s"] <= agg["wall_s"], name
    kids = ("cache.append", "cache.lay_window", "cache.book")
    mega = snap["cache.megastep"]
    assert mega["self_s"] == pytest.approx(
        mega["wall_s"] - sum(snap[k]["wall_s"] for k in kids), abs=1e-6)


def test_h2d_counts_the_staged_host_arrays(monkeypatch):
    """One megastep and one attend stage 7 host arrays, all through
    `_tensor`, each copied inside a `host.sync` span: the scatter's rows
    and columns, the window's columns, gate and countable mask, and the
    valid counts of the booking and of the attend.  The rows and the
    queries are tensors already."""
    rng = np.random.default_rng(3)
    loop = _loop()
    loop.prefill(0, *_rows(rng, 20))
    loop.prefill(1, *_rows(rng, 12))
    staged = []
    tensor = loop.cache._tensor

    def counted(x, dtype=None):
        t = tensor(x, dtype)
        staged.append(t.nbytes)
        return t

    monkeypatch.setattr(loop.cache, "_tensor", counted)
    with profile(activities=[ProfilerActivity.CPU]):
        _tier_step(loop, rng, [0, 1])
    counts = obs.snapshot()["counts"]
    assert len(staged) == 7
    assert counts == {"host.h2d": 7, "host.h2d_bytes": sum(staged)}
    assert obs.snapshot()["spans"]["host.sync"]["n"] == 7


def test_host_rows_count_once_each():
    """Rows handed over as numpy arrays count once each, at the step."""
    rng = np.random.default_rng(4)
    loop = _loop()
    loop.prefill(0, *_rows(rng, 20))
    loop.prefill(1, *_rows(rng, 12))
    with profile(activities=[ProfilerActivity.CPU]):
        loop.step_all({s: tuple(x.numpy() for x in _rows(rng, 1))
                       for s in (0, 1)})
    assert obs.snapshot()["counts"]["host.h2d"] == 6 + 4


def test_reads_to_the_host_open_a_sync_span():
    rng = np.random.default_rng(5)
    loop = _loop()
    loop.prefill(0, *_rows(rng, 20))
    with profile(activities=[ProfilerActivity.CPU]):
        loop.cache.stats                  # noqa: B018  (one read)
        loop.sync_ledger()                # one read
        loop.cache.refresh_gate()         # one read (the §VI counter)
    snap = obs.snapshot()
    assert snap["counts"] == {"host.d2h": 3}
    assert snap["spans"]["host.sync"]["n"] == 3


def test_spill_worker_spans_are_recorded():
    rng = np.random.default_rng(6)
    loop = _loop(slots=1, async_spill=True)
    loop.prefill(0, *_rows(rng, 20))
    with profile(activities=[ProfilerActivity.CPU]):
        loop.prefill(1, *_rows(rng, 12))     # evicts 0 on the worker
        loop.spill.flush()
    assert loop.counts["evicted"] == 1
    snap = obs.snapshot()["spans"]
    assert snap["spill.encode"]["n"] == 1
    assert snap["serve.evict"]["n"] == 1


def test_unbound_thread_records_nothing():
    """A profiler sees the thread that started it: another thread records
    only through `bind`."""
    def work():
        with obs.span("t.work"):
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        for fn in (work, obs.bind(work)):
            t = threading.Thread(target=fn)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    assert obs.snapshot()["spans"]["t.work"]["n"] == 1


def test_a_span_decorates_and_keeps_the_function():
    @obs.span("t.fn")
    def fn(a, b=2):
        """doc"""
        return a + b

    assert fn.__name__ == "fn" and fn.__doc__ == "doc"
    assert fn(1) == 3
    with profile(activities=[ProfilerActivity.CPU]):
        assert fn(1, b=5) == 6
    assert obs.snapshot()["spans"]["t.fn"]["n"] == 1


# ------------------------------------------------------- the readers
def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"obs_reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


TRACE = {"trace": {"span_steps": 8, "span_device_s": {
    "cache.view": 0.08, "attn.kv_repeat": 0.64, "moe.route": 0.01,
    "moe.dispatch": 0.02, "moe.combine": 0.03, "moe.experts": 0.5}}}
SNAP = {"spans": {
    "serve.step": {"n": 10, "wall_s": 0.05, "self_s": 0.01},
    "serve.attend": {"n": 10, "wall_s": 0.03, "self_s": 0.01},
    "serve.admit": {"n": 1, "wall_s": 0.004, "self_s": 0.001},
    "serve.retire": {"n": 1, "wall_s": 0.001, "self_s": 0.001},
    "cache.megastep": {"n": 10, "wall_s": 0.04, "self_s": 0.01},
    "host.sync": {"n": 2, "wall_s": 0.005, "self_s": 0.005}},
    "counts": {"host.h2d": 70, "host.h2d_bytes": 9000, "host.d2h": 2}}


@pytest.mark.parametrize("name,want", [
    ("kv.view_ms", 10.0), ("decode.kv_repeat_ms", 80.0),
    ("moe.dispatch_ms", 7.5), ("kv.host_ms", 8.0),
    ("kv.host_transfers", 7.2)])
def test_reader_on_a_synthetic_record(monkeypatch, name, want):
    monkeypatch.setattr(obs, "snapshot", lambda: SNAP)
    assert _reader(name)(TRACE) == pytest.approx(want)


@pytest.mark.parametrize("name", ["kv.view_ms", "decode.kv_repeat_ms",
                                  "moe.dispatch_ms", "kv.host_ms",
                                  "kv.host_transfers"])
def test_reader_without_the_spans_reads_nothing(monkeypatch, name):
    """A program with no spans (and no `repro_torch.obs`) gives None."""
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert _reader(name)({"trace": {"span_steps": 8,
                                    "span_device_s": {}}}) is None


# ------------------------------------------------ the ledger in int64
def test_device_ledger_is_exact_past_2_31():
    big = 3 * 2 ** 30                      # one step of long sessions
    tot = device_totals("cpu")
    raw = torch.full((4,), big // 4, dtype=torch.int32)    # per session
    for _ in range(3):
        kv_read_device(tot, raw, raw // 2)
    lay = torch.tensor([[True, False, True]])
    kv_repack_device(tot, lay, lanes=2, slot_bytes=2 ** 30,
                     strip_bytes=2 ** 10)
    device_record(tot, EV_READ, 2 ** 40, 2 ** 39, count=0)
    led = Ledger("kv")
    led.absorb(tot, tensor_class="kv")
    rows = led.as_dict()["kv"]["kv"]
    assert rows["read"] == {"raw_bytes": 3 * big + 2 ** 40,
                            "compressed_bytes": 3 * big // 2 + 2 ** 39,
                            "count": 3}
    assert rows["repack"] == {
        "raw_bytes": 3 * 2 * 2 ** 30,
        "compressed_bytes": 2 * (2 ** 30 + 2 ** 10) + 2 * 2 ** 30,
        "count": 3}
    assert tot.dtype == torch.int64


def test_cache_tallies_are_int64():
    st = _loop().cache.state
    for key in ("traffic", "pred_hits", "pred_misses", "packed_n", "raw_n"):
        assert st[key].dtype == torch.int64, key
