"""SlotKVCache: the batched CRAM-KV cache with per-slot sequence lifetimes
(port of `repro.serving.slots`).

Each batch lane is an independently progressing *slot*: per-slot token
counts (`tokens_b`) drive a per-slot valid mask; appends are per slot
(`append_slot`, `prefill_slot`) or vectorised per step (`append_active`,
`megastep`); the dirty / §VI-uncounted masks are per (slot, group);
`reset_slot` returns a lane to pristine state for the next admit; and
`slot_reference_state` is the per-slot rebuild oracle.

Gate semantics (DESIGN.md §12): every repack lays under the frozen
per-slot TARGET `_gate_b`, refreshed from the §VI counter only at
observation boundaries (`refresh_gate`) or forced by `set_gate_override`;
`_applied_b` records the gate each group was laid under, and
`serving.migrate` converges the two with bounded quanta.

`megastep` is the serve decode step: append scatter, window repack
(appends + migration quantum), §VI counter update, repack/read byte
booking and the LLP predictor observation.  The reference runs it as one
donated jitted dispatch; here it is eager code that updates the
preallocated state tensors in place, with one window-pack kernel launch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..bandwidth import Ledger
from ..compression.framing import DEFAULT_MARKER_KEY
from ..compression.gate import COUNTER_INIT, ENABLE_THRESHOLD
from ..kernels import ops as kops
from ..kernels.prefill_pack import prefill_pack
from ..kernels.ref import MARKER_LANES
from ..kv.cache import (CRAMKVCache, counter_update, kernel_cache_slice,
                        kv_bits, scatter_window)
from . import migrate as _migrate


def _pow2_window(idx: np.ndarray, n_groups: int) -> np.ndarray:
    """Pad a dirty column list to a power of two by repeating a real
    column (an idempotent re-lay; the host tallies count the padded
    window, as the reference's shape bucketing does)."""
    w = int(idx.size)
    wb = min(1 << (w - 1).bit_length(), n_groups)
    idx_pad = np.full(wb, idx[0], np.int64)
    idx_pad[:w] = idx
    return idx_pad


class SlotKVCache(CRAMKVCache):
    """CRAMKVCache whose batch lanes are independent sequence slots."""

    def __init__(self, max_pages: int, page: int, n_kv: int, head_dim: int,
                 *, batch: int = 1, policy: str = "dynamic",
                 packing: str = "pair", key: int = DEFAULT_MARKER_KEY,
                 counter_init: int = COUNTER_INIT,
                 ledger: Ledger | None = None, device="cuda"):
        # a serve cache may live-migrate between pair and quad layouts:
        # round capacity to the 4-page lcm so both geometries tile it
        max_pages = -(-max_pages // 4) * 4
        super().__init__(max_pages, page, n_kv, head_dim, batch=batch,
                         policy=policy, packing=packing, key=key,
                         counter_init=counter_init, ledger=ledger,
                         device=device)
        self._counter_init = int(counter_init)
        self.tokens_b = np.zeros(batch, np.int64)
        self._dirty_b = np.zeros((batch, self.n_groups), bool)
        self._uncounted_b = np.zeros((batch, self.n_groups), bool)
        self._gate_override: bool | None = None
        self._gate_b = self._policy_gate()
        self._applied_b = np.broadcast_to(
            self._gate_b[:, None], (batch, self.n_groups)).copy()

    # ------------------------------------------------------- slot geometry
    def slot_pages(self, slot: int) -> int:
        return int(-(-self.tokens_b[slot] // self.page))

    def slot_groups(self, slot: int) -> int:
        """Active page groups of one slot (its own prefix, not the max)."""
        return -(-self.slot_pages(slot) // self.group_lanes)

    def valid_per_page(self) -> np.ndarray:
        v = np.clip(self.tokens_b[:, None]
                    - np.arange(self.max_pages)[None, :] * self.page,
                    0, self.page)
        return v.astype(np.int32)

    # ------------------------------------------------------------ the gate
    def _policy_gate(self) -> np.ndarray:
        """(B,) bool target gate under the policy / override — the only
        place the §VI counter crosses to the host."""
        if self._gate_override is not None:
            return np.full(self.batch, self._gate_override, bool)
        if self.policy == "off":
            return np.zeros(self.batch, bool)
        if self.policy == "static":
            return np.ones(self.batch, bool)
        with obs.d2h():
            counter = self.state["counter"].cpu().numpy()
        return counter >= ENABLE_THRESHOLD

    def refresh_gate(self) -> np.ndarray:
        """Re-sample the per-slot target gate (an observation boundary)."""
        self._gate_b = self._policy_gate()
        return self._gate_b

    def set_gate_override(self, value: bool | None) -> np.ndarray:
        """Force the target gate on/off for every slot (None restores the
        policy gate); the layout converges incrementally."""
        self._gate_override = value
        return self.refresh_gate()

    # ----------------------------------------------------------- migration
    def migration_pending(self) -> np.ndarray:
        return _migrate.pending_mask(self)

    def migrated_upto(self, slot: int) -> int:
        return _migrate.migrated_upto(self, slot)

    def migration_quantum(self, budget: int = 1) -> int:
        return _migrate.quantum(self, budget)

    def drain_migration(self, slot: int | None = None) -> int:
        return _migrate.drain(self, slot)

    def migration_status(self) -> dict:
        return _migrate.status(self)

    def switch_packing(self, packing: str) -> None:
        _migrate.switch_packing(self, packing)

    # ------------------------------------------------------------- appends
    def append(self, k, v):
        """Uniform append to every slot; all slots at the same position."""
        assert (self.tokens_b == self.tokens_b[0]).all(), (
            "uniform append on heterogeneous slots; use append_slot/"
            "append_active")
        t0 = int(self.tokens_b[0])
        super().append(k, v)
        span = self.group_lanes * self.page
        lo, hi = t0 // span, (self.tokens - 1) // span
        self._dirty_b[:, lo:hi + 1] = True
        self._uncounted_b[:, lo:hi + 1] = True
        self.tokens_b[:] = self.tokens

    def append_slot(self, slot: int, k, v):
        """k/v (T, n_kv, d): append T tokens to one slot at its position."""
        kv = kv_bits(k, v, self.device)
        assert kv.dim() == 3, "append_slot takes one sequence (T, n_kv, d)"
        t = kv.shape[0]
        start = int(self.tokens_b[slot])
        assert start + t <= self.max_pages * self.page, "slot full"
        self.state["pages"][slot, start:start + t] = kv
        self._mark_dirty(slot, start, t)
        self.tokens_b[slot] += t
        self.tokens = int(self.tokens_b.max())

    def _check_slot_ids(self, slot_ids, t: int) -> None:
        assert ((slot_ids >= 0) & (slot_ids < self.batch)).all(), \
            f"slot ids out of range: {slot_ids}"
        assert np.unique(slot_ids).size == slot_ids.size, \
            f"duplicate slot ids: {slot_ids}"
        assert (self.tokens_b[slot_ids] + t
                <= self.max_pages * self.page).all(), "slot full"

    def _scatter_active(self, slot_ids: np.ndarray, kv) -> None:
        """Write kv (S, T, Hkv, D2) rows at each named slot's own position
        — one indexed write.  Only the named lanes are written (the
        reference computes every lane and discards the inactive ones)."""
        t = kv.shape[1]
        rows = self._tensor(slot_ids, torch.int64)[:, None]
        cols = (self._tensor(self.tokens_b[slot_ids], torch.int64)[:, None]
                + torch.arange(t, device=self.device)[None, :])
        self.state["pages"][rows, cols] = kv

    @obs.span("cache.append")
    def append_active(self, slot_ids, k, v):
        """One decode step for a subset of slots: k/v (S, T, n_kv, d) rows
        aligned with `slot_ids`, each at its slot's own position."""
        slot_ids = np.asarray(slot_ids, np.int64)
        kv = kv_bits(k, v, self.device)
        s, t = kv.shape[:2]
        assert s == slot_ids.size
        self._check_slot_ids(slot_ids, t)
        self._scatter_active(slot_ids, kv)
        for sl in slot_ids:
            self._mark_dirty(int(sl), int(self.tokens_b[sl]), t)
        self.tokens_b[slot_ids] += t
        self.tokens = int(self.tokens_b.max())

    def _mark_dirty(self, slot: int, start: int, t: int):
        span = self.group_lanes * self.page
        lo, hi = start // span, (start + t - 1) // span
        self._dirty_b[slot, lo:hi + 1] = True
        self._uncounted_b[slot, lo:hi + 1] = True

    # ------------------------------------------------------------- packing
    def _countable(self, idx: np.ndarray, width: int) -> np.ndarray:
        """(B, width) bool: groups idx[j] complete for slot b and not yet
        fed to b's §VI counter (pad columns False)."""
        span = self.group_lanes * self.page
        complete = (idx[None, :] + 1) * span <= self.tokens_b[:, None]
        countable = np.zeros((self.batch, width), bool)
        countable[:, :idx.size] = complete & self._uncounted_b[:, idx]
        u = self._uncounted_b[:, idx]
        u[complete] = False
        self._uncounted_b[:, idx] = u
        return countable

    def repack(self, gate: np.ndarray | None = None):
        """Re-lay the union of per-slot dirty groups in one window (clean
        slots' columns re-lay idempotently); §VI fitness is counted per
        slot, only on groups its own tokens complete, each once.  `gate`
        overrides the layout gate for this window; the default refreshes
        the policy gate (an observation boundary)."""
        idx = np.nonzero(self._dirty_b.any(0))[0]
        if idx.size == 0:
            return
        w = int(idx.size)
        enabled = (self.refresh_gate() if gate is None
                   else np.asarray(gate, bool))
        idx_t = self._tensor(idx, torch.int64)
        win = self._groups_view()[:, idx_t]
        slots_w, over_w, strips_w, lay, fit = self._pack_window(
            win, idx_t, enabled)
        st = self.state
        scatter_window(st, idx_t, slots_w, over_w, strips_w, lay)
        self._book_repack(w, enabled, lay)
        countable = self._countable(idx, w)
        if self.policy in ("dynamic", "auto"):
            counter_update(st["counter"], fit, self._tensor(countable))
        self._dirty_b[:] = False
        self._applied_b[:, idx] = enabled[:, None]
        self._last_enabled = enabled.copy()

    @obs.span("cache.lay_window")
    def _lay_window(self, idx: np.ndarray, fresh_pages: bool):
        """Shared tail of `megastep` / `prefill_slot`: pack the padded dirty
        window under the frozen gate, scatter it, book the repack bytes and
        the host tallies, update the §VI counter and the masks.  Returns
        the padded width."""
        idx_pad = _pow2_window(idx, self.n_groups)
        wb = idx_pad.size
        enabled = self._gate_b
        countable = self._countable(idx, wb)
        st = self.state
        idx_t = self._tensor(idx_pad, torch.int64)
        use_pack = self.policy != "off"
        en_t = self._tensor(enabled, torch.bool)
        if fresh_pages:
            slots_w, over_w, strips_w, lay, fit = prefill_pack(
                st["pages"], idx_t, self._marker_lanes, en_t,
                lanes=self.group_lanes, page=self.page, use_pack=use_pack)
        else:
            slots_w, over_w, strips_w, lay, fit = kops.layout_window(
                self._groups_view()[:, idx_t], self._marker_lanes[idx_t],
                en_t, use_pack=use_pack)
        scatter_window(st, idx_t, slots_w, over_w, strips_w, lay)
        self._book_repack(wb, enabled, lay)   # tallies the padded window
        if self.policy in ("dynamic", "auto"):
            counter_update(st["counter"], fit, self._tensor(countable))
        self._dirty_b[:] = False
        self._applied_b[:, idx] = enabled[:, None]
        self._last_enabled = enabled.copy()

    # ----------------------------------------------------- fused megastep
    @obs.span("cache.megastep")
    def megastep(self, slot_ids, k, v, *, budget: int = 0) -> dict:
        """One serve decode step: append k/v (S, T, n_kv, d) rows to
        `slot_ids`, re-lay the dirty window (+ up to `budget` migration
        columns) and book the step's read and repack traffic on the device
        accumulators.  Bit-identical to append_active -> migration_quantum
        -> repack -> account_step under the frozen gate."""
        assert len(slot_ids) > 0, "megastep needs at least one active slot"
        self.append_active(slot_ids, k, v)
        if budget:
            self.migration_quantum(budget)
        idx = np.nonzero(self._dirty_b.any(0))[0]
        self._lay_window(idx, fresh_pages=False)
        with obs.span("cache.book"):
            n = self._active_bucket()
            valid = self._valid(n)
            st = self.state
            raw_seq, cram_seq = kops.hbm_bytes_moved_device(
                kernel_cache_slice(st, n), valid,
                predictor=st["predictor"][:, :n], lanes=self.group_lanes)
            self._absorb_step(raw_seq, cram_seq, valid, n)
        return {"raw_per_seq": raw_seq, "cram_per_seq": cram_seq}

    # ------------------------------------------------------ fused prefill
    @obs.span("cache.prefill")
    def prefill_slot(self, slot: int, k, v, *, budget: int = 0) -> dict:
        """Install a whole prompt k/v (T, n_kv, d) into one slot: one
        scatter, one bulk pack of every touched group (`prefill_pack`), the
        §VI counter update from the pack results, repack byte booking, and
        the slot's LLP predictor row seeded from its own layout.
        Bit-identical to append_slot -> repack under the frozen gate.  The
        reference pads the prompt to a power of two with zero rows that land
        on never-written zero rows; the port writes the T rows alone."""
        t = k.shape[0]
        assert t > 0, "prefill_slot needs a non-empty prompt"
        self.append_slot(slot, k, v)
        if budget:
            self.migration_quantum(budget)
        idx = np.nonzero(self._dirty_b.any(0))[0]
        self._lay_window(idx, fresh_pages=True)
        st = self.state
        st["predictor"][slot] = st["packed_mask"][slot]
        return {"tokens": t, "groups": idx.size}

    # ------------------------------------------------------ slot lifecycle
    def reset_slot(self, slot: int):
        """Return a lane to pristine state for reuse (retire / evict)."""
        st = self.state
        for key in ("pages", "slots", "slots_overflow", "strips",
                    "packed_mask", "predictor"):
            st[key][slot] = 0
        st["counter"][slot] = self._counter_init
        self.tokens_b[slot] = 0
        self._dirty_b[slot] = False
        self._uncounted_b[slot] = False
        self._applied_b[slot] = self._gate_b[slot]
        self._last_enabled[slot] = bool(self._gate_b[slot])
        self.tokens = int(self.tokens_b.max())

    def slot_enabled_from_counter(self, counter: int) -> bool:
        """The gate a slot with this counter runs under (policy-resolved)."""
        if self.policy == "off":
            return False
        if self.policy == "static":
            return True
        return counter >= ENABLE_THRESHOLD

    def default_slot_gate(self) -> bool:
        """Target gate a freshly admitted slot lays under: the override if
        one is forced, else the policy gate at the counter init.  A
        spill-direct admit records this as its payload gate, so a later
        wake repacks like a hot-lane prefill."""
        if self._gate_override is not None:
            return bool(self._gate_override)
        return self.slot_enabled_from_counter(self._counter_init)

    def slot_reference_state(self, slot: int) -> dict:
        """Per-slot from-scratch rebuild over the slot's own active prefix
        under the per-group applied gate — the bit-exactness oracle,
        mid-migration states included.  The pack runs on a host copy of
        the pages, i.e. in its plain version, so on the card the oracle
        does not go through the kernel it checks."""
        g = self.slot_groups(slot)
        assert g > 0, "empty slot has no reference state"
        lanes = self.group_lanes
        pages = self.pages_view()[slot, : g * lanes]
        applied = self._applied_b[slot, :g]
        grouped = pages.reshape(g, lanes, self.page, self.n_kv, self.d2)
        raw = {
            "slots": grouped[:, 0],
            "slots_overflow": (grouped[:, 1] if self.packing == "pair"
                               else grouped[:, 1:]),
            "strips": torch.zeros((g, self.n_kv, self.d2 + MARKER_LANES),
                                  dtype=torch.int16, device=self.device),
            "packed_mask": torch.zeros((g,), dtype=torch.bool,
                                       device=self.device),
        }
        if not applied.any():          # never launches the pack kernel
            c = raw
        else:
            build = (kops.build_cram_cache if self.packing == "pair"
                     else kops.build_cram_cache_quad)
            with obs.d2h():
                host = pages.cpu()
            packed = {k: v.to(self.device)
                      for k, v in build(host, key=self.key).items()}
            if applied.all():
                c = {k: packed[k] for k in raw}
            else:
                sel = self._tensor(applied)
                c = {k: torch.where(
                        sel.reshape((g,) + (1,) * (raw[k].dim() - 1)),
                        packed[k], raw[k])
                     for k in raw}
        c = dict(c)
        c["markers"] = self.state["markers"][:g]
        return c

    def slot_physical_state(self, slot: int) -> dict:
        """The slot's physical rows over its own active prefix."""
        g = self.slot_groups(slot)
        st = self.state
        return {"slots": st["slots"][slot, :g],
                "slots_overflow": st["slots_overflow"][slot, :g],
                "strips": st["strips"][slot, :g],
                "packed_mask": st["packed_mask"][slot, :g],
                "markers": st["markers"][:g]}


__all__ = ["SlotKVCache"]
