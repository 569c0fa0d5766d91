"""The KV cache's byte accounting as ledger rows (port of the KV half of
`repro.bandwidth.adapters`: decode reads, repack writes and spill-tier
crossings).  A consumer module never adds byte counts itself; it calls one
of these adapters."""

from __future__ import annotations

import torch

from .ledger import EV_READ, EV_REPACK, EV_SPILL, Ledger, device_record


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
    packed-group count (0-d int32 tensor)."""
    groups = lay.numel()
    lay_n = lay.sum().to(torch.int32)
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
