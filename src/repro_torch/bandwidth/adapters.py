"""Byte accounting as ledger rows (port of `repro.bandwidth.adapters`: the
engine's STAT counters, decode reads, repack writes, spill-tier crossings,
checkpoint leaves and the gradient collective's wire bytes).  A consumer module never adds byte counts itself;
it calls one of these adapters."""

from __future__ import annotations

import numpy as np
import torch

from ..compression.framing import LINE_BYTES
from .ledger import (EV_PROBE, EV_READ, EV_REPACK, EV_SPILL, EV_WRITE,
                     Ledger, device_record)

# ---------------------------------------------------------------- trace engine


def engine_traffic(stats: dict, *, consumer: str = "engine") -> Ledger:
    """Ledger view of one engine run's STAT counters.

    Every access is one 64-byte line.  Category mapping:
      read   — demand fetches (`demand_reads`)
      probe  — extra LLP probes (`read_probes - demand_reads`) on data
               lines
      write  — dirty writebacks on "lines"; clean writebacks + invalidate
               line writes on "lines-clean"
      spill  — next-line prefetch extra accesses (`pf_extra_access`)
    and metadata-cache fills / writebacks as read / write rows of the
    "metadata" tensor class.  Total ledger bytes == `SimResult.accesses *
    LINE_BYTES`.
    """
    led = Ledger(consumer)
    L = LINE_BYTES

    def put(event, count, tensor_class):
        if count:
            led.record(event, raw=count * L, compressed=count * L,
                       count=count, tensor_class=tensor_class)

    put(EV_READ, stats["demand_reads"], "lines")
    put(EV_PROBE, stats["read_probes"] - stats["demand_reads"], "lines")
    put(EV_WRITE, stats["wb_dirty"], "lines")
    put(EV_WRITE, stats["wb_clean"] + stats["il_writes"], "lines-clean")
    put("spill", stats["pf_extra_access"], "lines")
    put(EV_READ, stats["meta_reads"], "metadata")
    put(EV_WRITE, stats["meta_wb"], "metadata")
    return led


def engine_breakdown(traffic: dict, *, consumer: str = "engine") -> dict:
    """The Fig. 8/15 access categories re-derived from `engine_traffic`
    rows (its `Ledger.as_dict()` form, as the workload summaries embed
    it), in line counts."""
    rows = traffic.get(consumer, {})

    def cnt(tensor_class, event):
        return rows.get(tensor_class, {}).get(event, {}).get("count", 0)

    return {
        "data": cnt("lines", "read") + cnt("lines", "write"),
        "metadata": cnt("metadata", "read") + cnt("metadata", "write"),
        "mispredict": cnt("lines", "probe"),
        "wbclean+inv": cnt("lines-clean", "write"),
        "prefetch": cnt("lines", "spill"),
        "total": sum(v["count"] for events in rows.values()
                     for v in events.values()),
    }


# ------------------------------------------------------------------- KV cache


def kv_decode_event(ledger: Ledger, bw: dict, *,
                    tensor_class: str = "kv") -> None:
    """One decode step's DMA traffic (a `kernels.ops.hbm_bytes_moved`
    result) as a read event: raw = uncompressed layout bytes, compressed =
    CRAM layout bytes including strip overhead and LLP-miss re-probes."""
    ledger.record(EV_READ, raw=bw["raw_bytes"], compressed=bw["cram_bytes"],
                  tensor_class=tensor_class, consumer="kv")


def kv_window_fold(ledger: Ledger, totals, *,
                   tensor_class: str = "kv") -> None:
    """Fold one decode window's device accumulator into the host ledger
    under consumer "kv", in O(1) `Ledger.record` calls."""
    ledger.absorb(totals, tensor_class=tensor_class, consumer="kv")


def kv_repack_event(ledger: Ledger, *, groups: int, packed: int, lanes: int,
                    slot_bytes: int, strip_bytes: int,
                    tensor_class: str = "kv") -> None:
    """Write traffic of (re)packing `groups` page groups, `packed` of which
    fit: a packed group writes one slot + strip, an unpacked group writes
    its `lanes` pages raw.  Raw baseline: every page written raw."""
    raw = groups * lanes * slot_bytes
    comp = (packed * (slot_bytes + strip_bytes)
            + (groups - packed) * lanes * slot_bytes)
    ledger.record(EV_REPACK, raw=raw, compressed=comp, count=groups,
                  tensor_class=tensor_class, consumer="kv")


def kv_repack_device(traffic, lay, *, lanes: int, slot_bytes: int,
                     strip_bytes: int):
    """Device form of `kv_repack_event` (same byte model), added into a
    `device_totals` accumulator in place.  Returns the accumulator and the
    packed-group count (0-d int64 tensor)."""
    groups = lay.numel()
    lay_n = lay.sum()
    raw = groups * lanes * slot_bytes
    comp = (lay_n * (slot_bytes + strip_bytes)
            + (groups - lay_n) * (lanes * slot_bytes))
    return device_record(traffic, EV_REPACK, raw, comp, count=groups), lay_n


def kv_read_device(traffic, raw_seq, cram_seq):
    """Device form of `kv_decode_event`: fold one decode step's
    per-sequence (raw, cram) byte columns — the fused kernel's second
    output — into the accumulator as ONE read event."""
    return device_record(traffic, EV_READ, raw_seq.sum(), cram_seq.sum(),
                         count=1)


def kv_spill_event(ledger: Ledger, *, raw: int, compressed: int,
                   direction: str = "evict",
                   tensor_class: str | None = None) -> tuple[int, int]:
    """One sequence crossing the device<->host spill link still compressed
    (`serving.SpillStore`): raw = what moving the decompressed KV pages
    would have cost, compressed = the payload bytes that crossed.  Exactly
    one spill row per evict and per restore, tensor class "kv-evict" or
    "kv-restore", consumer "kv"."""
    assert direction in ("evict", "restore"), direction
    return ledger.record(EV_SPILL, raw=raw, compressed=compressed, count=1,
                         tensor_class=tensor_class or f"kv-{direction}",
                         consumer="kv")


# ----------------------------------------------------------------- checkpoint


def classify_tensor(key: str, dtype=None) -> str:
    """Coarse tensor-class taxonomy for per-class policy decisions."""
    k = key.lower()
    if any(s in k for s in ("moment", "adam", "opt_state", "ema", "/mu",
                            "/nu")):
        return "moments"
    if "grad" in k:
        return "grads"
    if any(s in k for s in ("scale", "bias", "norm")):
        return "norms"
    return "weights"


def checkpoint_leaf_event(ledger: Ledger, *, key: str, raw_len: int,
                          stored_len: int, dtype=None) -> tuple[int, int]:
    """Book one checkpoint leaf's write; returns the (raw, stored) byte
    pair the manifest entry stores (read back from the ledger booking, so
    the manifest and the ledger cannot disagree)."""
    return ledger.record(EV_WRITE, raw=raw_len, compressed=stored_len,
                         tensor_class=classify_tensor(key, dtype))


def checkpoint_restore_event(ledger: Ledger, *, key: str, raw_len: int,
                             stored_len: int, dtype=None) -> None:
    ledger.record(EV_READ, raw=raw_len, compressed=stored_len,
                  tensor_class=classify_tensor(key, dtype))


# ----------------------------------------------------- gradient collective


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.prod(np.shape(x))) * np.asarray(x).dtype.itemsize


def tree_wire_bytes(tree) -> int:
    """Raw wire bytes of an uncompressed all-reduce of the tree's leaves
    (tensors or arrays, each at its own dtype's width)."""
    return sum(_nbytes(x) for x in _leaves(tree))


def int8_wire_bytes(tree) -> int:
    """Wire bytes of the int8 per-tensor quantized collective: one byte a
    element plus a 4-byte float32 scale a leaf."""
    return sum(int(np.prod(tuple(x.shape))) + 4 for x in _leaves(tree))


def grad_wire_event(ledger: Ledger, tree, *, enabled: bool,
                    steps: int = 1, tensor_class: str = "grads") -> None:
    """Book `steps` collective rounds: raw = uncompressed wire bytes,
    compressed = int8 bytes when the gate was enabled, raw otherwise."""
    raw = tree_wire_bytes(tree) * steps
    comp = (int8_wire_bytes(tree) if enabled else tree_wire_bytes(tree))
    ledger.record(EV_WRITE, raw=raw, compressed=comp * steps, count=steps,
                  tensor_class=tensor_class, consumer="grad")
