"""Level 2: run the hot entry points once and pin what the CPU tests
cannot see (port of `repro.analysis.jaxpr_audit`).

The reference traces each entry to a jaxpr; the port has no trace, so
each entry runs once, at the reference's audit shapes, under a
`TorchDispatchMode` that records every aten op, while the kernel wrappers
(`kernels.cuda_lib.kernel_wrapper`) report their calls.  For each entry
the audit pins:

  * `kernel_calls`: the calls of the port's kernel wrappers by kernel
    (the counterpart of `pallas_call`), counted on either device; on the
    card each is one count in its module's LAUNCHES;
  * `host_syncs`: ops that make the host wait for the device
    (`aten._local_scalar_dense`, ops whose output size depends on the
    data, any copy to the host) outside the wrappers — the counterpart
    of the host callbacks;
  * `aten_ops`: the aten ops outside the wrappers, the eager launches a
    card sees besides the kernels (a wrapper's ops are its plain version
    on the CPU and are not counted);
  * `f64`: whether any float64 tensor was made;
  * `inplace` where the reference pins donation: every buffer of the
    cache state keeps its storage (`data_ptr`) across the entry;
  * for `ckpt_pack_batch`: zero torch tensors and ops, and numpy out.

`hard_violations` holds the invariants that do not depend on the golden
(one kernel call per fused decode and per serve step or prompt, no
float64, no host sync, in-place state); a host sync the port cannot drop
without changing a result is pinned in the golden with its reason
(`known_syncs`) and allowed at exactly that count.  `compare` holds the
rest against `tests/golden/torch_launch_audit.json`.  Regenerate the golden after an
intentional change with
`python -m repro_torch.analysis --audit --device cpu --update-golden`.
"""

from __future__ import annotations

import gc
import json
from collections import Counter
from pathlib import Path

import numpy as np

from .engine import REPO_ROOT

GOLDEN_PATH = REPO_ROOT / "tests" / "golden" / "torch_launch_audit.json"

# the port's functions each entry runs ("path suffix:qualname"); R3 holds
# them to its strict scope
AUDITED = {
    "engine_chunk": ("repro_torch/core/engine.py:build_engine.run_chunk",),
    "fused_decode_pair": ("repro_torch/kernels/ops.py:"
                          "decode_attention_fused",),
    "fused_decode_quad": ("repro_torch/kernels/ops.py:"
                          "decode_attention_fused",),
    "fused_decode_batched": ("repro_torch/kernels/ops.py:"
                             "decode_attention_fused",),
    "pack_window": ("repro_torch/kernels/ops.py:pack_window",),
    "serve_scatters": ("repro_torch/serving/slots.py:"
                       "SlotKVCache._scatter_active",
                       "repro_torch/kv/cache.py:CRAMKVCache._scatter_tokens"),
    "serve_megastep": ("repro_torch/serving/slots.py:SlotKVCache.megastep",),
    "serve_prefill": ("repro_torch/serving/slots.py:"
                      "SlotKVCache.prefill_slot",),
    "kv_step_booking": ("repro_torch/kv/cache.py:CRAMKVCache._absorb_step",),
    "ckpt_pack_batch": (),
}

# entries with exactly one kernel call (the reference's one pallas_call)
ONE_KERNEL = ("fused_decode_pair", "fused_decode_quad",
              "fused_decode_batched", "serve_megastep", "serve_prefill")
# ops that wait for the device's result on a CUDA tensor
SYNC_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::nonzero", "aten::nonzero_static",
    "aten::masked_select", "aten::unique_consecutive", "aten::_unique2",
    "aten::_unique", "aten::unique_dim", "aten::equal", "aten::is_nonzero",
})
# the golden's keys that hold on the card as on the CPU
DEVICE_FREE = ("kernel_calls", "host_syncs")


def _recorder():
    """A TorchDispatchMode that counts aten ops, host syncs and float64
    outputs, and the kernel wrappers' calls (it is also their observer:
    ops inside a wrapper call are left out of the op and sync counts)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.syncs = Counter(), Counter()
            self.kernel_calls = Counter()
            self.f64 = False
            self.depth = 0

        def enter(self, name):
            if self.depth == 0:
                self.kernel_calls[name] += 1
            self.depth += 1

        def exit(self, name):
            self.depth -= 1

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            if any(t.dtype == torch.float64 for t in outs):
                self.f64 = True
            if self.depth == 0:
                name = func.name()
                self.ops[name] += 1
                ins = [t for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)]
                to_host = any(t.device.type != "cpu" for t in ins) and any(
                    t.device.type == "cpu" for t in outs)
                if name in SYNC_OPS or to_host:
                    self.syncs[name] += 1
            return out

    return Recorder()


def _storage(tree) -> dict:
    """{key: data_ptr} of every tensor of a (nested) cache state."""
    import torch

    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{key}.{k}": p for k, p in _storage(v).items()})
        elif isinstance(v, torch.Tensor):
            out[key] = v.data_ptr()
    return out


def _launch_counts() -> Counter:
    """The kernel modules' LAUNCHES (CUDA launches only), summed."""
    from ..kernels import bdi_pack, compress_scan, cram_attention, engine_scan

    out = Counter()
    for mod in (bdi_pack, cram_attention, compress_scan, engine_scan):
        out.update(mod.LAUNCHES)
    return out


def _recorded(fn, device, *, state=None) -> dict:
    """Run fn() once under the recorder (on a card also under
    `torch.cuda.set_sync_debug_mode("error")`, so that an op that makes
    the host wait raises, and with the LAUNCHES it added); with `state`
    (a cache's state dict) also whether every buffer kept its storage."""
    import torch

    from ..kernels import cuda_lib

    before = _storage(state) if state is not None else None
    card = torch.device(device).type == "cuda"
    launched = _launch_counts()
    rec = _recorder()
    cuda_lib.OBSERVERS.append(rec)
    try:
        if card:
            torch.cuda.set_sync_debug_mode("error")
        with rec:
            fn()
    finally:
        if card:
            torch.cuda.set_sync_debug_mode(0)
        cuda_lib.OBSERVERS.remove(rec)
    inplace = None if state is None else _storage(state) == before
    launched = {k: v for k, v in (_launch_counts() - launched).items() if v}
    return {
        "pinned": {"kernel_calls": dict(sorted(rec.kernel_calls.items())),
                   "host_syncs": int(sum(rec.syncs.values())),
                   "aten_ops": int(sum(rec.ops.values()))},
        "f64": rec.f64,
        "inplace": inplace,
        "info": {"ops": dict(sorted(rec.ops.items())),
                 "syncs": dict(sorted(rec.syncs.items())),
                 "launches": dict(sorted(launched.items())) if card
                 else None},
    }


# --------------------------------------------------------------- the entries


def _entry_engine_chunk(device) -> dict:
    """core/engine step: one chunk of the cram scheme over 64 events of
    libq (one E1 launch on the card)."""
    import torch

    from ..core import schemes as schemes_registry
    from ..core.engine import (SimConfig, build_engine, device_tables,
                               trace_tensors)
    from ..core.traces import build_workload
    from ..kernels.engine_scan import pack_evict_table

    cfg = SimConfig()
    sch = schemes_registry.resolve("cram")
    eng = build_engine(cfg)
    _spec, addrs, wr, pa, pc, qd, _f = build_workload("libq", 256)
    trace = trace_tensors(cfg, addrs[None, :64], wr[None, :64], pa[None],
                          pc[None], qd[None], device)
    flags = torch.from_numpy(sch.flags()[None]).to(device)
    params = torch.from_numpy(sch.params(cfg)[None]).to(device)
    carry = eng.init_state(params, 1, device=device)
    # made once for a sweep, before its first launch
    pack_evict_table(device_tables(cfg, carry[0].device))
    return _recorded(lambda: eng.run_chunk(carry, flags, params, *trace),
                     device)


def _fused_decode(device, lanes: int, batched: bool) -> dict:
    import torch

    from ..kernels import ops as kops

    rng = np.random.default_rng(0)
    pages = torch.from_numpy(
        rng.integers(-4, 4, (4, 8, 1, 64)).astype(np.int16)).to(device)
    build = (kops.build_cram_cache if lanes == 2
             else kops.build_cram_cache_quad)
    cache = build(pages)
    q = torch.zeros((2, 1, 32), dtype=torch.float32, device=device)
    if batched:
        cache = {k: (torch.stack([v, v]) if k != "markers" else v)
                 for k, v in cache.items()}
        vp = torch.full((2, 4), 8, dtype=torch.int32, device=device)
    else:
        vp = torch.full((4,), 8, dtype=torch.int32, device=device)
    return _recorded(lambda: kops.decode_attention_fused(
        q, cache, vp, lanes=lanes), device)


def _entry_pack_window(device) -> dict:
    """The incremental pack window (SlotKVCache repack's kernel call)."""
    import torch

    from ..kernels import ops as kops

    a = torch.zeros((1, 2, 8, 1, 64), dtype=torch.int16, device=device)
    b = torch.zeros((1, 2, 8, 1, 64), dtype=torch.int16, device=device)
    ml = torch.zeros((2, 2), dtype=torch.int16, device=device)
    en = torch.ones((1,), dtype=torch.bool, device=device)
    return _recorded(lambda: kops.pack_window(a, b, ml, en), device)


def _kv(device, rng, batch, tokens):
    """A synthetic KV step as float32 tensors on `device` (made before the
    recorded call, as the reference's audit passes device arrays)."""
    import torch

    from ..kv import synthetic_kv_stream

    k, v = synthetic_kv_stream(rng, batch, tokens, 1, 32)
    return (torch.from_numpy(k).to(device), torch.from_numpy(v).to(device))


def _slot_cache(device):
    from ..serving.slots import SlotKVCache

    return SlotKVCache(max_pages=4, page=8, n_kv=1, head_dim=32, batch=2,
                       policy="static", device=device)


def _entry_serve_scatters(device) -> dict:
    """The serve step's append scatters: `SlotKVCache._scatter_active`
    (per-slot positions) and the uniform append's token scatter, each
    writing the preallocated pages in place (the reference donates
    them)."""
    from ..kv import CRAMKVCache
    from ..kv.cache import kv_bits

    rng = np.random.default_rng(0)
    cache = _slot_cache(device)
    kv = kv_bits(*_kv(device, rng, 2, 1), device)
    rep = _recorded(lambda: cache._scatter_active(np.array([0, 1]), kv),
                    device, state=cache.state)
    flat = CRAMKVCache(max_pages=4, page=8, n_kv=1, head_dim=32, batch=2,
                       policy="static", device=device)
    tok = _recorded(lambda: flat._scatter_tokens(kv), device,
                    state=flat.state)
    rep["pinned"]["scatter_tokens_inplace"] = bool(tok["inplace"])
    rep["pinned"]["scatter_tokens_aten_ops"] = tok["pinned"]["aten_ops"]
    rep["pinned"]["host_syncs"] += tok["pinned"]["host_syncs"]
    rep["f64"] |= tok["f64"]
    return rep


def _entry_kv_step_booking(device) -> dict:
    """The device-resident step accounting (`CRAMKVCache._absorb_step`)
    after a real append and repack: the predictor observation and the
    byte columns folded into the device accumulators."""
    import torch

    from ..kv import CRAMKVCache

    rng = np.random.default_rng(0)
    cache = CRAMKVCache(max_pages=4, page=8, n_kv=1, head_dim=32, batch=2,
                        policy="static", device=device)
    cache.append(*_kv(device, rng, 2, 16))
    cache.account_step()
    n = cache.n_active_groups
    valid = cache._valid(n)
    raw = torch.zeros((2,), dtype=torch.int32, device=device)
    return _recorded(lambda: cache._absorb_step(raw, raw, valid, n),
                     device, state=cache.state)


def _entry_serve_megastep(device) -> dict:
    """The serve decode step (`SlotKVCache.megastep`): append scatter,
    window repack, §VI counter update, byte booking and the LLP
    observation, the state updated in place, with exactly one kernel
    call (the window pack)."""
    rng = np.random.default_rng(0)
    cache = _slot_cache(device)
    cache.megastep([0, 1], *_kv(device, rng, 2, 8))
    k, v = _kv(device, rng, 2, 1)
    return _recorded(lambda: cache.megastep([0, 1], k, v), device,
                     state=cache.state)


def _entry_serve_prefill(device) -> dict:
    """The chunked-prefill ingest (`SlotKVCache.prefill_slot`): one prompt
    scatter and one bulk pack of every touched group (two full groups
    into slot 0, T = 32), in place, with exactly one kernel call."""
    rng = np.random.default_rng(0)
    cache = _slot_cache(device)
    k, v = _kv(device, rng, 1, 32)
    return _recorded(lambda: cache.prefill_slot(0, k[0], v[0]), device,
                     state=cache.state)


def _entry_ckpt_pack_batch(device) -> dict:
    """checkpoint pack_batch: host-resident by design — zero torch tensors
    and ops, numpy in, numpy out, for every registered batch codec (the
    device is not used)."""
    import torch

    from ..compression.codecs import codec_names, get_codec

    lines = np.arange(4 * 64, dtype=np.uint8).reshape(4, 64)
    audited, outs = [], []

    def run():
        for name in codec_names():
            codec = get_codec(name)
            if codec.pack_batch is None:
                continue
            outs.append(codec.pack_batch(lines))
            audited.append(name)

    def live():
        gc.collect()
        return sum(issubclass(type(o), torch.Tensor)
                   for o in gc.get_objects())

    before = live()
    rep = _recorded(run, device)
    after = live()
    created = (max(0, after - before) + rep["pinned"]["aten_ops"]
               + sum(not isinstance(o, np.ndarray) for o in outs))
    return {"pinned": {"torch_tensors_created": created,
                       "codecs_audited": len(audited),
                       "kernel_calls": rep["pinned"]["kernel_calls"],
                       "host_syncs": rep["pinned"]["host_syncs"]},
            "f64": rep["f64"], "inplace": None,
            "info": {"codecs": audited, "launches": rep["info"]["launches"],
                     "syncs": rep["info"]["syncs"]}}


ENTRIES = {
    "engine_chunk": _entry_engine_chunk,
    "fused_decode_pair": lambda d: _fused_decode(d, 2, batched=False),
    "fused_decode_quad": lambda d: _fused_decode(d, 4, batched=False),
    "fused_decode_batched": lambda d: _fused_decode(d, 2, batched=True),
    "pack_window": _entry_pack_window,
    "serve_scatters": _entry_serve_scatters,
    "serve_megastep": _entry_serve_megastep,
    "serve_prefill": _entry_serve_prefill,
    "kv_step_booking": _entry_kv_step_booking,
    "ckpt_pack_batch": _entry_ckpt_pack_batch,
}


def audit(device="cuda", names=None) -> dict:
    """Run every entry (or `names`) on `device`; returns {entry: {pinned,
    f64, inplace, info}}.  Raises without a card unless device="cpu"."""
    from ..device import resolve_device

    dev = resolve_device(device)
    return {name: ENTRIES[name](dev) for name in (names or ENTRIES)}


def known_syncs(golden: dict | None) -> dict[str, int]:
    """{entry: host syncs} the golden pins with a reason."""
    return {name: e["known_syncs"]["count"]
            for name, e in (golden or {}).get("entries", {}).items()
            if "known_syncs" in e}


def hard_violations(report: dict, known: dict | None = None) -> list[str]:
    """Golden-independent invariants: no host sync (beyond the count a
    `known` entry allows), no float64, state updated in place where the
    reference donates it, exactly one kernel call per fused decode, serve
    step and prompt ingest, and a host-only checkpoint pack.  These hold
    even right after --update-golden."""
    known = known or {}
    bad = []
    for name, entry in report.items():
        pinned = entry["pinned"]
        syncs = pinned.get("host_syncs", 0)
        if syncs and syncs != known.get(name):
            bad.append(f"{name}: {syncs} host sync(s) "
                       f"{entry['info'].get('syncs')} — the host waits for "
                       "the card inside a hot entry")
        if entry.get("f64"):
            bad.append(f"{name}: a float64 tensor was made")
        if entry.get("inplace") is False or \
                pinned.get("scatter_tokens_inplace") is False:
            bad.append(f"{name}: a cache buffer was replaced, not updated "
                       "in place")
        calls = sum(pinned.get("kernel_calls", {}).values())
        if name in ONE_KERNEL and calls != 1:
            bad.append(f"{name}: expected exactly 1 kernel call, found "
                       f"{pinned.get('kernel_calls')}")
    ck = report.get("ckpt_pack_batch", {}).get("pinned", {})
    if ck.get("torch_tensors_created") or ck.get("kernel_calls"):
        bad.append("ckpt_pack_batch: the checkpoint batch pack made torch "
                   "tensors — it is a host-numpy cold path by design")
    return bad


def compare(report: dict, golden: dict, keys=None) -> list[str]:
    """Drift of the pinned counts (all, or only `keys`) and of f64 /
    inplace against the golden."""
    bad = []
    for name, gentry in golden.get("entries", {}).items():
        entry = report.get(name)
        if entry is None:
            bad.append(f"{name}: entry missing from audit")
            continue
        for key, want in gentry["pinned"].items():
            if keys is not None and key not in keys:
                continue
            got = entry["pinned"].get(key)
            if got != want:
                bad.append(f"{name}: pinned {key} = {got}, golden pins "
                           f"{want}")
        for key in ("f64", "inplace"):
            if entry.get(key) != gentry.get(key):
                bad.append(f"{name}: {key} = {entry.get(key)}, golden "
                           f"pins {gentry.get(key)}")
    return bad


def golden_view(report: dict, old: dict | None = None) -> dict:
    """What --update-golden writes: the compared fields, and each pinned
    sync reason of the `old` golden whose count still holds."""
    out = {}
    for name, e in report.items():
        out[name] = {"pinned": e["pinned"], "f64": e["f64"],
                     "inplace": e["inplace"]}
        ks = (old or {}).get("entries", {}).get(name, {}).get("known_syncs")
        if ks and ks["count"] == e["pinned"].get("host_syncs"):
            out[name]["known_syncs"] = ks
    return {"entries": out}


def run(golden_path: Path | None = None, *, update: bool = False,
        device="cuda") -> dict:
    """Audit + compare; the dict the CLI embeds in its JSON report.  The
    golden is the CPU record: on a card only the device-independent
    counts (DEVICE_FREE, f64, inplace) are compared."""
    from ..device import resolve_device

    golden_path = Path(golden_path or GOLDEN_PATH)
    golden = (json.loads(golden_path.read_text()) if golden_path.exists()
              else None)
    report = audit(device)
    on_cpu = resolve_device(device).type == "cpu"
    mismatches = hard_violations(report, known_syncs(golden))
    if update:
        if not on_cpu:
            raise ValueError("the golden is the CPU record: update it with "
                             "--device cpu")
        golden_path.parent.mkdir(parents=True, exist_ok=True)
        golden_path.write_text(json.dumps(golden_view(report, golden),
                                          indent=2, sort_keys=True) + "\n")
    elif golden is not None:
        mismatches += compare(report, golden,
                              keys=None if on_cpu else DEVICE_FREE)
    else:
        mismatches.append(f"golden file {golden_path} missing — run "
                          "--audit --device cpu --update-golden")
    return {"entries": report, "golden": str(golden_path), "device":
            str(device), "updated": update, "mismatches": mismatches}
