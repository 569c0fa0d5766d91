"""Incremental live migration of a serving SlotKVCache (port of
`repro.serving.migrate`, DESIGN.md §12).

When the hot-tier gate flips or the packing changes mid-serve, the live
cache converges to the new layout a bounded budget of page-group columns
per decode step instead of by a stop-the-world rebuild.  The machinery is
derivational: `cache._gate_b` (B,) is the frozen per-slot TARGET gate,
`cache._applied_b` (B, n_groups) the gate each group was last laid under,
and a group is pending iff it is inside its slot's active prefix and the
two differ.  `quantum` marks at most `budget` pending columns dirty; the
normal repack re-lays them.  `switch_packing` rebuilds the raw layout of
a new group geometry from the packing-independent logical pages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bandwidth.adapters import kv_repack_device
from ..compression.framing import DOMAIN_PAIR, DOMAIN_QUAD
from ..kernels.ref import MARKER_LANES, marker_to_lanes, slot_markers


def _raw_relayout(pages, lay0, traffic, *, lanes, page, slot_bytes,
                  strip_bytes):
    """The RAW physical layout of a new group geometry straight from the
    logical pages, booking the active groups' raw re-lay as repack write
    traffic (`lay0` is an all-False mask over the active groups)."""
    b, t_max, hkv, d2 = pages.shape
    n = t_max // (lanes * page)
    grouped = pages.reshape(b, n, lanes, page, hkv, d2)
    slots = grouped[:, :, 0].clone()
    over = (grouped[:, :, 1] if lanes == 2 else grouped[:, :, 1:]).clone()
    strips = torch.zeros((b, n, hkv, d2 + MARKER_LANES), dtype=torch.int16,
                         device=pages.device)
    mask = torch.zeros((b, n), dtype=torch.bool, device=pages.device)
    kv_repack_device(traffic, lay0, lanes=lanes, slot_bytes=slot_bytes,
                     strip_bytes=strip_bytes)
    return slots, over, strips, mask


def active_groups(cache) -> np.ndarray:
    """(B,) int: page-group count of each slot's own active prefix."""
    pages_b = -(-cache.tokens_b // cache.page)
    return (-(-pages_b // cache.group_lanes)).astype(np.int64)


def pending_mask(cache) -> np.ndarray:
    """(B, n_groups) bool: groups laid under a gate that differs from the
    slot's target — derived, never stored."""
    g_b = active_groups(cache)
    active = np.arange(cache.n_groups)[None, :] < g_b[:, None]
    return active & (cache._applied_b != cache._gate_b[:, None])


def migrated_upto(cache, slot: int) -> int:
    """Leading groups of `slot` already laid under its target gate."""
    pend = pending_mask(cache)[slot]
    nz = np.flatnonzero(pend)
    return int(nz[0]) if nz.size else int(active_groups(cache)[slot])


def quantum(cache, budget: int) -> int:
    """Mark at most `budget` pending group columns dirty; returns the
    number claimed."""
    if budget <= 0:
        return 0
    pend = pending_mask(cache)
    cols = np.flatnonzero(pend.any(0))[:budget]
    if cols.size:
        cache._dirty_b[:, cols] = True
    return int(cols.size)


def drain(cache, slot: int | None = None) -> int:
    """Settle migration now (of one slot, or all) under the frozen target
    gate; returns the column count drained."""
    pend = pending_mask(cache)
    if slot is not None:
        only = np.zeros_like(pend)
        only[slot] = pend[slot]
        pend = only
    cols = np.flatnonzero(pend.any(0))
    if cols.size:
        cache._dirty_b[:, cols] = True
        cache.repack(gate=cache._gate_b)
    return int(cols.size)


def status(cache) -> dict:
    """Migration progress snapshot."""
    pend = pending_mask(cache)
    return {
        "migrating": bool(pend.any()),
        "pending_groups": int(pend.sum()),
        "pending_columns": int(pend.any(0).sum()),
        "watermarks": [migrated_upto(cache, b) for b in range(cache.batch)],
    }


def switch_packing(cache, packing: str) -> None:
    """Re-geometry the live cache to a new packing layout: the raw layout
    of the new geometry, every active group `applied=False`, so the
    budgeted quanta promote it.  The §VI counter survives; the predictor
    and the uncounted-fitness mask are geometry-indexed and reset."""
    assert packing in ("pair", "quad"), packing
    if packing == cache.packing:
        return
    lanes = 2 if packing == "pair" else 4
    assert cache.max_pages % lanes == 0, (
        f"max_pages={cache.max_pages} not divisible by {lanes}-lane groups")
    b, n_groups = cache.batch, cache.max_pages // lanes
    dev = cache.device
    lay0 = torch.zeros((int(active_groups(cache).sum()),), dtype=torch.bool,
                       device=dev)
    st = cache.state
    slots, over, strips, mask = _raw_relayout(
        st["pages"], lay0, st["traffic"], lanes=lanes, page=cache.page,
        slot_bytes=cache.slot_bytes, strip_bytes=cache.strip_bytes)
    domain = DOMAIN_PAIR if packing == "pair" else DOMAIN_QUAD
    markers = slot_markers(n_groups, cache.key, domain=domain)
    cache.packing = packing
    cache.group_lanes = lanes
    cache.n_groups = n_groups
    cache._marker_lanes = torch.from_numpy(marker_to_lanes(markers)).to(dev)
    st["slots"], st["slots_overflow"], st["strips"] = slots, over, strips
    st["packed_mask"] = mask
    st["markers"] = torch.from_numpy(markers.view(np.int32).copy()).to(dev)
    st["predictor"] = torch.zeros((b, n_groups), dtype=torch.bool,
                                  device=dev)
    cache._dirty_b = np.zeros((b, n_groups), bool)
    cache._uncounted_b = np.zeros((b, n_groups), bool)
    cache._applied_b = np.zeros((b, n_groups), bool)
    cache._last_enabled = np.zeros(b, bool)
    # base-class 1-D masks: unused by SlotKVCache but kept shape-true
    cache._dirty = np.zeros(n_groups, bool)
    cache._uncounted = np.zeros(n_groups, bool)


__all__ = ["active_groups", "pending_mask", "migrated_upto", "quantum",
           "drain", "status", "switch_packing"]
