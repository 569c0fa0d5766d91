#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one card and hold its kernels against
their plain versions.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

  1. the card's name and power limit; build of the CUDA kernels from
     `src/repro_torch/csrc` (nvcc, one process per source, in parallel);
  2. kernels at the phi4-mini-3.8B KV geometry (page 16, 8 KV heads,
     head_dim 128, 24 query heads): K1/K2 (window pack) bit-exact against
     their plain versions, K3 (decode on the compressed cache) within
     atol = rtol = 2e-3 (summation order, __expf) with the bytes exact;
  3. the serve launcher at the full published phi4-mini-3.8B shape (32
     layers, random weights), once with pair and once with quad packing,
     with the wall time of model build, model decode and serve tier, and
     the device time of one decode step from torch.profiler;
  4. the serve tier alone: 200-token prompts in 8 slots (6 compressible,
     1 incompressible, 1 alternating), 48 decode steps each followed by an
     attend, every attend held against the plain attention on the same
     state, and the final physical state bit-exact against the per-slot
     rebuild (which packs with the plain version);
  5. every kernel launch of phases 3 and 4, held against the plain version
     on a copy of the inputs that launch was given: K1/K2 bit-exact on all
     five outputs, K3 within atol = rtol = 2e-3 with the bytes exact;
  6. timings of every kernel at the shapes phases 3 and 4 gave it, beside
     its plain version, its bound and, for K3, scaled_dot_product_attention
     on the materialised K/V: device time (ten calls captured in one CUDA
     graph, CUDA events, median of 20 replays) and one eager call with the
     host's dispatch (median of 20 after warm-up).

Phases 3 and 4 drive four paths (launcher pair, launcher quad, serve
attend pair, serve attend quad); the launch counters are set to 0 just
before each and read just after it, and every kernel a path runs must
have launched in it.  The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  It needs one CUDA card and a checkout of
the repository around it.  `--report PATH` also writes the full report as
JSON.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
PAGE, N_KV, HEAD_DIM, N_HEADS = 16, 8, 128, 24
ATOL = RTOL = 2e-3

KERNELS = {
    "pack_pair": ("src/repro_torch/csrc/bdi_pack.cu",
                  "src/repro/kernels/bdi_pack.py:60"),
    "pack_quad": ("src/repro_torch/csrc/bdi_pack.cu",
                  "src/repro/kernels/bdi_pack.py:118"),
    "decode_attention_pair": ("src/repro_torch/csrc/cram_attention.cu",
                              "src/repro/kernels/cram_attention.py:309"),
    "decode_attention_quad": ("src/repro_torch/csrc/cram_attention.cu",
                              "src/repro/kernels/cram_attention.py:309"),
}
PACK_OUTPUTS = ("slots", "overflow", "strips", "lay", "fit")
# the paths of the main path, each with the kernels it must launch
PATHS = {
    "launcher_pair": ("pack_pair",),
    "launcher_quad": ("pack_quad",),
    "serve_attend_pair": ("pack_pair", "decode_attention_pair"),
    "serve_attend_quad": ("pack_quad", "decode_attention_quad"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ------------------------------------------------------------ recording

class Recorder:
    """Keeps a copy of the inputs and outputs of every launch a CUDA
    wrapper makes while a path is driven, with the path and the ServeLoop
    call it came from ("prefill", "step_all", "attend" or "other"), and
    counts the ServeLoop calls of each path."""

    def __init__(self, torch):
        self.torch = torch
        self.calls: list = []
        self.loop_calls: dict = {}
        self.path = None
        self.part = "other"

    def _clone(self, x):
        return x.clone() if self.torch.is_tensor(x) else x

    def wrap(self, name_of, fn, launches: dict):
        def wrapped(*args, **kw):
            if self.path is None:
                return fn(*args, **kw)
            inputs = [self._clone(a) for a in args]
            before = sum(launches.values())
            outs = fn(*args, **kw)
            if sum(launches.values()) > before:
                self.calls.append({
                    "name": name_of(args, kw), "path": self.path,
                    "part": self.part, "args": inputs, "kw": dict(kw),
                    "outs": [self._clone(o) for o in outs]})
            return outs
        return wrapped

    def wrap_part(self, part: str, fn):
        def wrapped(*args, **kw):
            if self.path is not None:
                key = (self.path, part)
                self.loop_calls[key] = self.loop_calls.get(key, 0) + 1
            outer, self.part = self.part, part
            try:
                return fn(*args, **kw)
            finally:
                self.part = outer
        return wrapped

    def most_frequent(self, name, paths):
        """(args, kw) of the first call of the shape `name` was launched
        with most often on `paths`, or None."""
        by_shape: dict = {}
        for c in self.calls:
            if c["name"] != name or c["path"] not in paths:
                continue
            shape = tuple(tuple(a.shape) for a in c["args"]
                          if hasattr(a, "shape"))
            by_shape.setdefault(shape, []).append(c)
        if not by_shape:
            return None
        first = max(by_shape.values(), key=len)[0]
        return first["args"], first["kw"]


# ----------------------------------------------------------------- timing

def _event_ms(torch, fn, reps: int) -> float:
    """Median over `reps` of the CUDA-event time around one fn()."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def call_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Time of one eager call, host dispatch included (what the serve step
    pays): median of `reps` after `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _event_ms(torch, fn, reps)


def device_ms(torch, fn, reps: int = 20, inner: int = 10) -> float:
    """Device time of one call: `inner` calls captured back to back in one
    CUDA graph, so the host's dispatch between launches is not counted;
    median over `reps` replays, divided by `inner`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(torch, graph.replay, reps) / inner


def nbytes(t) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------- phase 2: kernels

def kv_window(torch, rng, b, w, lanes, kinds, device):
    """(B, W, lanes, page, Hkv, D2) int16 window; kinds[b] is
    "compressible", "incompressible" or "mixed" (alternating groups)."""
    from repro_torch.kv import synthetic_kv_stream
    from repro_torch.kv.cache import kv_bits

    t = w * lanes * PAGE
    rows = []
    for kind in kinds:
        kc, vc = synthetic_kv_stream(rng, 1, t, N_KV, HEAD_DIM)
        ki, vi = synthetic_kv_stream(rng, 1, t, N_KV, HEAD_DIM,
                                     compressible=False)
        if kind == "incompressible":
            kc, vc = ki, vi
        elif kind == "mixed":
            span = lanes * PAGE
            for g in range(1, w, 2):
                kc[:, g * span:(g + 1) * span] = ki[:, g * span:(g + 1) * span]
                vc[:, g * span:(g + 1) * span] = vi[:, g * span:(g + 1) * span]
        rows.append(kv_bits(kc[0], vc[0], device))
    win = torch.stack(rows).reshape(b, w, lanes, PAGE, N_KV, 2 * HEAD_DIM)
    return win.contiguous()


def check_pack(torch, rng, device) -> dict:
    """K1/K2 against the plain version; returns the largest |difference|
    seen on any output, by kernel name (0 when bit-exact)."""
    from repro_torch.kernels import bdi_pack

    errs = {}
    b, w = 4, 8
    kinds = ["compressible", "incompressible", "mixed", "compressible"]
    enabled = torch.tensor([True, True, True, False], device=device)
    for lanes in (2, 4):
        win = kv_window(torch, rng, b, w, lanes, kinds, device)
        win[3, 5, :, PAGE // 2:] = 0          # a partial page group
        mk = torch.from_numpy(rng.integers(-2**15, 2**15, (w, 2)).astype(
            "int16")).to(device)
        got = bdi_pack.pack_window_cuda(win, mk, enabled)
        torch.cuda.synchronize()
        want = bdi_pack.pack_window_plain(win, mk, enabled)
        err = 0
        for name, g, r in zip(PACK_OUTPUTS, got, want, strict=True):
            err = max(err, (g.int() - r.int()).abs().max().item())
            if not torch.equal(g, r):
                fail(f"K{1 if lanes == 2 else 2} {name} differs from the "
                     "plain version")
        errs["pack_pair" if lanes == 2 else "pack_quad"] = float(err)
        print(f"kernel check: pack lanes={lanes} bit-exact on 5 outputs "
              f"(fit per group {got[4].sum().item()}/{b * w})")
    return errs


def attention_inputs(torch, rng, lanes, b, n_groups, device, shared=False):
    """Per-sequence (or shared) compressed caches from mixed streams, a
    ragged valid mask (zero-valid lanes, partial pages) and a predictor
    with mismatches, in the flat physical view."""
    from repro_torch.kernels import ops

    kinds = ["compressible", "mixed", "incompressible", "compressible"]
    caches = []
    for i in range(1 if shared else b):
        win = kv_window(torch, rng, 1, n_groups, lanes, [kinds[i % 4]],
                        device)
        build = ops.build_cram_cache if lanes == 2 else ops.build_cram_cache_quad
        caches.append(build(win.reshape(-1, PAGE, N_KV, 2 * HEAD_DIM)))
    keys = ("slots", "slots_overflow", "strips", "packed_mask")
    if shared:
        cache = {k: caches[0][k] for k in keys}
    else:
        cache = {k: torch.stack([c[k] for c in caches]) for k in keys}
    cache["markers"] = caches[0]["markers"]
    lead = () if shared else (b,)
    tokens = torch.from_numpy(rng.integers(
        1, n_groups * lanes * PAGE, lead or (1,))).to(device)
    if not shared:
        tokens[1] = 0                               # a zero-valid lane
    pages = torch.arange(n_groups * lanes, device=device)
    valid = torch.clamp(tokens.reshape(-1, 1) - pages * PAGE, 0, PAGE)
    valid = valid.reshape(*lead, -1).to(torch.int32)
    pred = cache["packed_mask"].clone()
    flip = torch.from_numpy(rng.random(tuple(pred.shape)) < 0.3).to(device)
    pred = pred ^ flip
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    slots, strips, markers, fvalid = pv(cache, valid)
    q = torch.from_numpy(rng.standard_normal(
        (b, N_HEADS, HEAD_DIM)).astype("float32")).to(device)
    return (q, slots.contiguous(), strips.contiguous(), markers.contiguous(),
            fvalid.to(torch.int32).contiguous(),
            pred.to(torch.int32).contiguous())


def check_attention_once(torch, args, kw, label) -> float:
    from repro_torch.kernels import cram_attention as ca

    out, byts = ca.cram_decode_attention_batched_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref, ref_b = ca.cram_decode_attention_batched_plain(*args, **kw)
    if not torch.isfinite(out).all():
        fail(f"K3 {label}: non-finite output")
    if not torch.allclose(out, ref, atol=ATOL, rtol=RTOL):
        fail(f"K3 {label}: max |diff| {(out - ref).abs().max().item():.3e} "
             f"beyond atol=rtol={ATOL}")
    if not torch.equal(byts, ref_b):
        fail(f"K3 {label}: bytes {byts.tolist()} != {ref_b.tolist()}")
    return (out - ref).abs().max().item()


def check_attention(torch, rng, device) -> dict:
    """K3 against the plain version; returns the largest |difference| by
    kernel name."""
    errs = {}
    for lanes in (2, 4):
        for shared in (False, True):
            args = attention_inputs(torch, rng, lanes, 8, 8, device,
                                    shared=shared)
            for bg in (1, 4):
                kw = dict(lanes=lanes, block_groups=bg, shared_cache=shared)
                err = check_attention_once(
                    torch, args, kw, f"lanes={lanes} shared={shared} "
                    f"block_groups={bg}")
                print(f"kernel check: decode lanes={lanes} shared={shared} "
                      f"block_groups={bg} max|diff| {err:.3e}, bytes exact")
                name = ("decode_attention_pair" if lanes == 2
                        else "decode_attention_quad")
                errs[name] = max(errs.get(name, 0.0), err)
    return errs


# --------------------------------------------------------- phase 3 / phase 4

def _timed(torch, walls: dict, outs: dict, name: str, fn):
    """fn, with its wall time (ended by a device synchronise) added to
    walls[name] and its last result kept in outs[name]."""
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        outs[name] = fn(*args, **kw)
        torch.cuda.synchronize()
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return outs[name]
    return wrapped


def decode_device_ms(torch, model, batch: int, steps: int = 4):
    """Device time of one greedy decode step of `model` from
    torch.profiler (the kernels' own durations), or None when the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    cache = model.init_cache(batch, steps + 1)
    tok = torch.zeros((batch, 1), dtype=torch.int64,
                      device=model.embed.device)
    model.decode_step(tok, cache, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(1, steps + 1):
            model.decode_step(tok, cache, i)
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return dev_us * 1e-3 / steps if dev_us else None


def run_launcher(torch, packing: str) -> dict:
    """The serve launcher at the full phi4-mini-3.8B shape; returns its
    report with the wall seconds of model build, model prefill + decode
    and serve tier under "walls"."""
    from repro_torch.launch import serve

    argv = ["--arch", "phi4_mini_3_8b", "--no-smoke", "--batch", "4",
            "--prompt-len", "32", "--gen", "32", "--kv-packing", packing]
    walls: dict = {}
    outs: dict = {}
    parts = {"build": serve.build, "_timed_decode": serve._timed_decode,
             "_serve_tier": serve._serve_tier}
    for name, fn in parts.items():
        setattr(serve, name, _timed(torch, walls, outs, name, fn))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            report = serve.main(argv)
    finally:
        for name, fn in parts.items():
            setattr(serve, name, fn)
    step_ms = 1e3 * report["batch"] / report["tokens_per_s"]
    dev_ms = decode_device_ms(torch, outs.pop("build"), report["batch"])
    report["walls"] = {"model_build_s": walls["build"],
                       "model_prefill_decode_s": walls["_timed_decode"],
                       "serve_tier_s": walls["_serve_tier"],
                       "decode_step_ms": step_ms,
                       "decode_step_device_ms": dev_ms,
                       "decode_device_busy_share": (
                           None if dev_ms is None else dev_ms / step_ms)}
    st = report["serve_tier"]
    if not (st["admitted"] == st["retired"] == 4):
        fail(f"launcher {packing}: admitted {st['admitted']} retired "
             f"{st['retired']}")
    for key in ("prefill_tokens_per_s", "tokens_per_s"):
        if not math.isfinite(report[key]) or report[key] <= 0:
            fail(f"launcher {packing}: {key} = {report[key]}")
    rows = [row for tc in report["traffic"].values() for ev in tc.values()
            for row in ev.values()]
    if not rows or any(v < 0 for row in rows for v in row.values()):
        fail(f"launcher {packing}: missing or negative ledger rows (int32 "
             f"accumulator overflow): {report['traffic']}")
    return report


def serve_attend_phase(torch, packing: str, device, *, slots=8,
                       prompt=200, steps=48, rng_seed=7) -> dict:
    """ServeLoop at the phi4 KV geometry; each attend is compared with the
    plain attention on the same state.  Slots 0-5 are compressible, slot 6
    incompressible and slot 7 alternates 64-token runs of both: the
    compressible tokens are within one bf16 ulp of each other, so only the
    others give scores that differ across tokens, and the check fails
    unless the reference output of slot 6 is far from the plain mean of
    its V (so it sees the softmax weights, not only the lane decode).
    Returns the loop and the max |diff| seen."""
    import numpy as np

    from repro_torch.kernels import cram_attention as ca
    from repro_torch.kernels import ops
    from repro_torch.kv import synthetic_kv_stream
    from repro_torch.serving import ServeLoop

    rng = np.random.default_rng(rng_seed)
    total = prompt + steps
    k, v = synthetic_kv_stream(rng, slots, total, N_KV, HEAD_DIM)
    ki, vi = synthetic_kv_stream(rng, slots, total, N_KV, HEAD_DIM,
                                 compressible=False)
    k[6], v[6] = ki[6], vi[6]
    for t0 in range(64, total, 128):
        k[7, t0:t0 + 64], v[7, t0:t0 + 64] = (ki[7, t0:t0 + 64],
                                              vi[7, t0:t0 + 64])
    v6 = torch.from_numpy(v[6]).to(device).to(torch.bfloat16).float()
    loop = ServeLoop(slots=slots, max_pages=-(-total // PAGE), page=PAGE,
                     n_kv=N_KV, head_dim=HEAD_DIM, policy="static",
                     packing=packing, device=device)
    for i in range(slots):
        loop.prefill(i, k[i, :prompt], v[i, :prompt])
    worst, spread = 0.0, math.inf
    lanes = loop.cache.group_lanes
    pv = ops.physical_view if lanes == 2 else ops.physical_view_quad
    for step in range(steps):
        t = prompt + step
        loop.step_all({i: (k[i, t:t + 1], v[i, t:t + 1])
                       for i in range(slots)})
        q = rng.standard_normal((slots, N_HEADS, HEAD_DIM)).astype("float32")
        out = loop.attend({i: q[i] for i in range(slots)})
        c = loop.cache
        n = c._active_bucket()
        kc = c._kernel_cache(n)
        s, st, mk, fv = pv(kc, c._valid(n))
        ref, _ = ca.cram_decode_attention_batched_plain(
            torch.from_numpy(q).to(device), s, st, mk, fv,
            kc["packed_mask"], lanes=lanes)
        got = torch.stack([out[i] for i in range(slots)])
        if not torch.isfinite(got).all():
            fail(f"serve attend {packing}: non-finite output")
        if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
            fail(f"serve attend {packing} step {step}: max |diff| "
                 f"{(got - ref).abs().max().item():.3e}")
        worst = max(worst, (got - ref).abs().max().item())
        mean_v = v6[:t + 1].mean(0).repeat_interleave(N_HEADS // N_KV, 0)
        spread = min(spread, (ref[6] - mean_v).abs().max().item())
    if spread < 10 * ATOL:
        fail(f"serve attend {packing}: the incompressible slot's output is "
             f"within {spread:.3e} of the mean of its V; the check would "
             "not see wrong softmax weights")
    print(f"serve attend {packing}: slot 6 output at least {spread:.3e} "
          "from the mean of its V (the weights matter)")
    if (loop.cache.state["traffic"] < 0).any():
        fail(f"serve attend {packing}: a ledger accumulator went negative "
             "(int32 overflow)")
    return {"loop": loop, "max_abs_err": worst, "spread": spread}


def check_final_state(torch, loop, packing) -> None:
    """After a repack, every slot's physical rows bit-exact against the
    per-slot rebuild, which packs on the host with the plain version."""
    c = loop.cache
    c.repack()
    for slot in range(loop.n_slots):
        phys = c.slot_physical_state(slot)
        want = c.slot_reference_state(slot)
        for key in phys:
            if not torch.equal(phys[key], want[key]):
                fail(f"serve attend {packing}: slot {slot} {key} differs "
                     "from the per-slot rebuild")
    s = loop.summary()
    if s["decode_saving"] <= 0:
        fail(f"serve attend {packing}: decode saving {s['decode_saving']}")
    print(f"serve attend {packing}: final state bit-exact on {loop.n_slots} "
          f"slots, decode saving {s['decode_saving']}")


# ------------------------------------------ phase 5: the main path's calls

def check_main_path(torch, rec) -> dict:
    """Every launch the main path made, held against the plain version on
    a copy of its inputs: K1/K2 bit-exact on all five outputs, K3 within
    atol = rtol = ATOL with the bytes exact.  Returns by kernel the calls
    checked, their distinct shapes and the largest |difference|."""
    from repro_torch.kernels import bdi_pack
    from repro_torch.kernels import cram_attention as ca

    seen: dict = {}
    for i, c in enumerate(rec.calls):
        name, args = c["name"], c["args"]
        label = f"{name} launch {i} ({c['path']}, {c['part']})"
        if name.startswith("pack"):
            want = bdi_pack.pack_window_plain(*args)
            for key, g, r in zip(PACK_OUTPUTS, c["outs"], want, strict=True):
                if not torch.equal(g, r):
                    fail(f"{label}: {key} differs from the plain version")
            err, shape = 0.0, tuple(args[0].shape)
        else:
            out, byts = c["outs"]
            ref, ref_b = ca.cram_decode_attention_batched_plain(*args,
                                                                **c["kw"])
            if not torch.isfinite(out).all():
                fail(f"{label}: non-finite output")
            err = (out - ref).abs().max().item()
            if not torch.allclose(out, ref, atol=ATOL, rtol=RTOL):
                fail(f"{label}: max |diff| {err:.3e} beyond atol=rtol={ATOL}")
            if not torch.equal(byts, ref_b):
                fail(f"{label}: bytes {byts.tolist()} != {ref_b.tolist()}")
            shape = tuple(args[1].shape)
        s = seen.setdefault(name, {"calls": 0, "shapes": set(),
                                   "max_abs_err": 0.0})
        s["calls"] += 1
        s["shapes"].add(shape)
        s["max_abs_err"] = max(s["max_abs_err"], err)
    for name, s in seen.items():
        s["shapes"] = sorted(s["shapes"])
        exact = ("bit-exact on 5 outputs" if name.startswith("pack")
                 else f"max|diff| {s['max_abs_err']:.3e}, bytes exact")
        print(f"main-path check: {name}: {s['calls']} launches at "
              f"{len(s['shapes'])} shapes {s['shapes']}, {exact}")
    return seen


# -------------------------------------------------------- phase 6: timings

def pack_bound(saved) -> tuple[float, str]:
    win, mk, en = saved[0][:3]
    b, w, lanes, page, hkv, d2 = win.shape
    moved = (nbytes(win) + nbytes(mk) + nbytes(en)       # read
             + nbytes(win)                               # slots + overflow
             + b * w * hkv * (d2 + 2) * 2 + 2 * b * w)   # strips, lay, fit
    return _bound(moved)


def _bound(moved: int) -> tuple[float, str]:
    """All three kernels are bound by bytes: integer compares and shifts
    (K1/K2), and per live position 4 flops per element against 2 bytes of
    K||V (K3), are far below the card's rates for the bytes they move."""
    return moved / HBM_BYTES_PER_S * 1e3, "bytes"


def attention_bound(torch, saved) -> tuple[float, str]:
    q, slots, strips, markers, valid, pred = saved[0]
    shared = saved[1].get("shared_cache", False)
    b, hq, d = q.shape
    n, page, hkv, d2 = slots.shape[-4:]
    v = valid if not shared else valid[None]
    top = torch.clamp(v.max(-1).values, max=page)          # live rows/slot
    dead = (v.sum((-1, -2)) == 0)[:, None]                 # no valid: all
    rows = int(torch.where(dead, torch.full_like(top, page), top).sum())
    live_slots = int((torch.where(dead, torch.ones_like(top), top) > 0).sum())
    moved = (nbytes(q) + rows * hkv * d2 * 2 + live_slots * hkv * (d2 + 2) * 2
             + nbytes(markers) + nbytes(valid) + nbytes(pred)
             + b * hq * d * 4 + b * 8)
    return _bound(moved)


def sdpa_call(torch, saved):
    """scaled_dot_product_attention on the already-materialised bf16 K/V of
    the same inputs, as a zero-argument call (a yardstick; the port never
    calls it)."""
    from repro_torch.kernels.ref import decode_slots, strip_is_packed

    q, slots, strips, markers, valid, _ = saved[0]
    kw = saved[1]
    lanes = kw["lanes"]
    b, hq, d = q.shape
    if kw.get("shared_cache"):
        slots, strips, valid = slots[None], strips[None], valid[None]
        slots, strips, valid = (x.expand(b, *x.shape[1:])
                                for x in (slots, strips, valid))
    n, page, hkv, d2 = slots.shape[-4:]
    pages = decode_slots(slots, strips, strip_is_packed(strips, markers),
                         lanes)
    kv = pages.reshape(b, n * lanes * page, hkv, d2).view(torch.bfloat16)
    g = hq // hkv                                        # (B, Hq, T, D)
    k = kv[..., :d].repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    vv = kv[..., d:].repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(page, device=q.device) < valid[..., None]).reshape(
        b, 1, 1, -1)
    qb = q.to(torch.bfloat16)[:, :, None, :]             # (B, Hq, 1, D)
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qb, k, vv, attn_mask=mask)


def _times(torch, row: dict, key: str, fn) -> None:
    """row[key + "ms"]: device time of one call (CUDA graph replay);
    row[key + "call_ms"]: one eager call, host dispatch included."""
    row[key + "ms"] = device_ms(torch, fn)
    row[key + "call_ms"] = call_ms(torch, fn)


def timing_rows(torch, rec, phase: str, paths) -> dict:
    """Device and eager-call times of every kernel at the most frequent
    shape the main path gave it, beside its plain version, its bound and,
    for K3, the library call."""
    from repro_torch.kernels import bdi_pack
    from repro_torch.kernels import cram_attention as ca

    rows = {}
    for name in ("pack_pair", "pack_quad"):
        saved = rec.most_frequent(name, paths)
        if saved is None:
            continue
        args = saved[0]
        r = rows[name] = {"shape": list(args[0].shape), "library_ms": None,
                          "library_call_ms": None}
        _times(torch, r, "", lambda: bdi_pack.pack_window_cuda(*args))
        _times(torch, r, "plain_", lambda: bdi_pack.pack_window_plain(*args))
        r["bound_ms"], r["bound_by"] = pack_bound(saved)
    for name in ("decode_attention_pair", "decode_attention_quad"):
        saved = rec.most_frequent(name, paths)
        if saved is None:
            continue
        args, kw = saved
        r = rows[name] = {"shape": list(args[1].shape)}
        _times(torch, r, "", lambda: ca.cram_decode_attention_batched_cuda(
            *args, **kw))
        _times(torch, r, "plain_",
               lambda: ca.cram_decode_attention_batched_plain(*args, **kw))
        _times(torch, r, "library_", sdpa_call(torch, saved))
        r["bound_ms"], r["bound_by"] = attention_bound(torch, saved)

    def fmt(x):
        return "none" if x is None else f"{x:.4f} ms"

    for name, r in rows.items():
        print(f"timing [{phase}] {name} shape {r['shape']}: device time: "
              f"kernel {fmt(r['ms'])}, plain {fmt(r['plain_ms'])}, library "
              f"{fmt(r['library_ms'])}, bound {fmt(r['bound_ms'])} "
              f"({r['bound_by']}); one eager call: kernel "
              f"{fmt(r['call_ms'])}, plain {fmt(r['plain_call_ms'])}, "
              f"library {fmt(r['library_call_ms'])}")
    return rows


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", type=pathlib.Path, default=None,
                    help="also write the full report (launcher reports, "
                         "every timing) as JSON to this path")
    report_path = ap.parse_args(argv).report
    import torch

    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.kernels import bdi_pack, cuda_lib
    from repro_torch.kernels import cram_attention as ca

    t_start = time.perf_counter()
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"device: {kind}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # phase 1: build
    cuda_lib.load()
    print(f"build: {cuda_lib.build_seconds():.2f} s")

    # phase 2: kernels against their plain versions
    rng = np.random.default_rng(0)
    errs = {**check_pack(torch, rng, device),
            **check_attention(torch, rng, device)}

    # phases 3 + 4: four paths, each with the launch counters from 0
    from repro_torch.serving import ServeLoop

    rec = Recorder(torch)
    bdi_pack.pack_window_cuda = rec.wrap(
        lambda a, kw: "pack_pair" if a[0].shape[2] == 2 else "pack_quad",
        bdi_pack.pack_window_cuda, bdi_pack.LAUNCHES)
    ca.cram_decode_attention_batched_cuda = rec.wrap(
        lambda a, kw: ("decode_attention_pair" if kw.get("lanes", 2) == 2
                       else "decode_attention_quad"),
        ca.cram_decode_attention_batched_cuda, ca.LAUNCHES)
    for part in ("prefill", "step_all", "attend"):
        setattr(ServeLoop, part, rec.wrap_part(part, getattr(ServeLoop, part)))
    by_path: dict = {}

    def drive(path, fn):
        for counts in (bdi_pack.LAUNCHES, ca.LAUNCHES):
            for key in counts:
                counts[key] = 0
        rec.path = path
        try:
            result = fn()
        finally:
            rec.path = None
        got = {**bdi_pack.LAUNCHES, **ca.LAUNCHES}
        for name in PATHS[path]:
            if got[name] == 0:
                fail(f"{path}: the {name} kernel never launched")
        calls = [c for c in rec.calls if c["path"] == path]
        if len(calls) != sum(got.values()):
            fail(f"{path}: {len(calls)} launches recorded, counters say "
                 f"{got}")
        steps = rec.loop_calls.get((path, "step_all"), 0)
        by_path[path] = {}
        for name in PATHS[path]:
            mine = [c for c in calls if c["name"] == name]
            prefill = sum(c["part"] == "prefill" for c in mine)
            decode = sum(c["part"] in ("step_all", "attend") for c in mine)
            by_path[path][name] = {
                "launches": got[name], "prefill": prefill,
                "decode_steps": steps,
                "per_decode_step": decode / steps if steps else None}
        print(f"launches [{path}]: {by_path[path]}")
        return result

    reports = {}
    for packing in ("pair", "quad"):
        t0 = time.perf_counter()
        reports[packing] = drive(f"launcher_{packing}",
                                 lambda p=packing: run_launcher(torch, p))
        walls = reports[packing]["walls"]
        print(f"launcher {packing}: {time.perf_counter() - t0:.1f} s "
              f"(model build {walls['model_build_s']:.2f} s, model prefill + "
              f"decode {walls['model_prefill_decode_s']:.3f} s, serve tier "
              f"{walls['serve_tier_s']:.3f} s over "
              f"{reports[packing]['serve_tier']['serve_steps']} steps; decode "
              f"step {walls['decode_step_ms']:.2f} ms, of it on the device "
              f"{walls['decode_step_device_ms']} ms, busy share "
              f"{walls['decode_device_busy_share']}), "
              f"decode {reports[packing]['tokens_per_s']} tokens/s, prefill "
              f"{reports[packing]['prefill_tokens_per_s']} tokens/s")
    phases = {}
    for packing in ("pair", "quad"):
        phases[packing] = drive(
            f"serve_attend_{packing}",
            lambda p=packing: serve_attend_phase(torch, p, device))
    for packing, ph in phases.items():
        check_final_state(torch, ph["loop"], packing)
        print(f"serve attend {packing}: attend max |diff| vs plain "
              f"{ph['max_abs_err']:.3e}")

    # phase 5: every launch of phases 3 and 4 against its plain version
    main_path = check_main_path(torch, rec)

    # phase 6: timings at the shapes of phases 3 and 4
    launcher_rows = timing_rows(torch, rec, "launcher",
                                ("launcher_pair", "launcher_quad"))
    serve_rows = timing_rows(torch, rec, "serve-attend",
                             ("serve_attend_pair", "serve_attend_quad"))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = serve_rows[name]
        paths = {path: per[name] for path, per in by_path.items()
                 if name in per}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p["launches"] for p in paths.values()),
            "launches_by_path": paths,
            "max_abs_err": max(errs[name], main_path[name]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    if report_path is not None:
        report_path.parent.mkdir(parents=True, exist_ok=True)
        report_path.write_text(json.dumps(
            {"card": card, "launcher": reports, "kernels": kernels,
             "main_path_checks": main_path,
             "timing": {"launcher": launcher_rows,
                        "serve-attend": serve_rows}}, indent=1))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
