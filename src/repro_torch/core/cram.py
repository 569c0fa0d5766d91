"""Exact functional model of a CRAM compressed memory system (§IV-§VI), a
numpy copy of `repro.core.cram` over the port's codecs and markers.

This is the bit-true reference: a real memory image (numpy uint8), real
FPC+BDI codecs, real markers, real inversion + LIT, real LLP, real ganged
eviction and a real group-granular LLC.  Reads interpret lines *only* via the
implicit-metadata markers (never via side-channel ground truth), exactly as
the proposed hardware would.  The correctness contract — every read returns
the last written value — is property-tested against the reference in
tests/test_torch_cram_functional.py.

Bandwidth accounting matches the paper's breakdown (Fig. 15):
  read probes (demand + misprediction re-probes), dirty writebacks,
  clean compressed writebacks, invalidate (Marker-IL) writes, LIT spills.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..compression import hybrid as cc
from ..compression.framing import LINE_BYTES, PAYLOAD_BUDGET
from ..compression.gate import DynamicController
from ..compression.layouts import LANE_LEVEL, PRED_SLOT, probe_chain
from ..compression.marker import (
    LineStatus,
    MarkerSpec,
    classify_line,
    invert_line,
    needs_inversion,
)
from ..compression.predictor import LLP
from .evict_logic import evict_plan
from .lit import LIT
from .llc import GroupEntry, GroupLLC


@dataclass
class CRAMStats:
    demand_reads: int = 0
    read_probes: int = 0          # memory reads incl. misprediction re-probes
    wb_dirty: int = 0
    wb_clean: int = 0             # compressed writebacks of clean data (cost)
    il_writes: int = 0            # invalidate writes (cost)
    prefetch_installed: int = 0
    prefetch_used: int = 0        # benefit events
    llc_hits: int = 0
    llc_misses: int = 0

    @property
    def extra_probes(self) -> int:
        return self.read_probes - self.demand_reads

    def total_mem_accesses(self, lit_extra: int = 0) -> int:
        return (
            self.read_probes + self.wb_dirty + self.wb_clean + self.il_writes
            + lit_extra
        )

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


class CRAMSystem:
    """LLC + memory controller + compressed memory image.

    policy: 'uncompressed' | 'static' (always compress) | 'dynamic'
    """

    def __init__(
        self,
        n_lines: int = 4096,
        llc_sets: int = 64,
        llc_ways: int = 4,
        policy: str = "static",
        compress_clean: bool = True,
        key: bytes = b"cram-key",
        lit_capacity: int = 16,
        lit_overflow: str = "memory_mapped",
    ):
        assert n_lines % 4 == 0
        self.n_lines = n_lines
        self.mem = np.zeros((n_lines, LINE_BYTES), dtype=np.uint8)
        self.spec = MarkerSpec(key=key)
        self.lit = LIT(capacity=lit_capacity, overflow_policy=lit_overflow)
        self.llp = LLP()
        self.dyn = DynamicController()
        self.llc = GroupLLC(n_sets=llc_sets, ways=llc_ways)
        self.stats = CRAMStats()
        self.policy = policy
        self.compress_clean = compress_clean

    # ---------------------------------------------------------------- helpers
    def _slot_addr(self, group: int, slot: int) -> int:
        return group * 4 + slot

    def _compression_enabled_for(self, group: int) -> bool:
        if self.policy == "uncompressed":
            return False
        if self.policy == "static":
            return True
        # dynamic: sampled sets always compress; followers obey the counter
        return self.llc.is_sampled(group) or self.dyn.enabled()

    def _write_uncompressed_slot(self, slot_addr: int, data: np.ndarray) -> None:
        """Store an uncompressed line, handling marker collisions (§V-A).

        On a LIT overflow with the 'regenerate' policy, markers are re-keyed
        and all of memory re-encoded BEFORE this slot is written, so the
        scan sees a consistent image; the write then retries under the new
        markers (which it will almost surely not collide with).
        """
        for _ in range(3):  # retry bound: repeated collisions ~ 2^-64
            if not needs_inversion(data, slot_addr, self.spec):
                self.mem[slot_addr] = data
                self.lit.remove(slot_addr)
                return
            if (self.lit.would_overflow(slot_addr)
                    and self.lit.overflow_policy == "regenerate"
                    and not getattr(self, "_regenerating", False)):
                self._regenerate_markers()
                continue  # retry under the new marker generation
            self.mem[slot_addr] = invert_line(data)
            self.lit.insert(slot_addr)
            return
        raise AssertionError("repeated marker collisions after re-keying")

    def _regenerate_markers(self) -> None:
        """LIT overflow Option-2: new keys, re-encode every resident line."""
        self._regenerating = True
        try:
            # decode the whole memory under old markers, re-key, re-encode
            contents = {}
            for g in range(self.n_lines // 4):
                st, lines = self._scan_group_state(g)
                contents[g] = (st, lines)
            self.spec.regenerate()
            self.lit.entries.clear()
            self.lit.overflow_map.clear()
            self.lit.overflowed = False
            for g, (st, lines) in contents.items():
                self._materialize_group(g, st, lines)
        finally:
            self._regenerating = False

    def _scan_group_state(self, group: int):
        """(test/maintenance path) read a whole group via markers."""
        lines = {}
        state_guess = None  # layout is re-materialized uncompressed
        for slot in range(4):
            sa = self._slot_addr(group, slot)
            raw = self.mem[sa]
            st = classify_line(raw, sa, self.spec)
            if st == LineStatus.COMP4:
                for i, l in enumerate(cc.unpack_group(raw, 4)):
                    lines[i] = l
            elif st == LineStatus.COMP2:
                lanes = [slot, slot + 1]
                for i, l in zip(lanes, cc.unpack_group(raw, 2), strict=True):
                    lines[i] = l
            elif st == LineStatus.INVALID:
                continue
            else:
                d = raw.copy()
                if st == LineStatus.MAYBE_INVERTED and self.lit.contains(sa):
                    d = invert_line(d)
                lines[slot] = d
        return state_guess, lines

    def _materialize_group(self, group: int, _state, lines: dict) -> None:
        """Rewrite a group uncompressed (used only by marker regeneration)."""
        for lane in range(4):
            sa = self._slot_addr(group, lane)
            data = lines.get(lane, np.zeros(LINE_BYTES, dtype=np.uint8))
            self._write_uncompressed_slot(sa, data)

    # ------------------------------------------------------------------ fetch
    def _fetch(self, addr: int):
        """Read line `addr` from compressed memory using markers + LLP.

        Returns (lines: {lane: (64,) uint8}, level: observed compressibility,
                 probes: memory accesses used).
        """
        group, lane = addr // 4, addr % 4
        if lane == 0:
            chain = [0]
            predicted = None
        else:
            pred_level = self.llp.predict_level(addr)
            predicted = int(PRED_SLOT[lane][pred_level])
            chain = probe_chain(lane, predicted)

        probes = 0
        found: dict[int, np.ndarray] = {}
        level = 0
        for slot in chain:
            sa = self._slot_addr(group, slot)
            raw = self.mem[sa]
            probes += 1
            st = classify_line(raw, sa, self.spec)
            if st == LineStatus.COMP4:
                # slot 0 only; contains the whole group
                for i, l in enumerate(cc.unpack_group(raw, 4)):
                    found[i] = l
                level = 2
                break
            if st == LineStatus.COMP2:
                lanes = (0, 1) if slot == 0 else (2, 3)
                if lane in lanes:
                    for i, l in zip(lanes, cc.unpack_group(raw, 2), strict=True):
                        found[i] = l
                    level = 1
                    break
                continue  # packed pair that does not include us
            if st == LineStatus.INVALID:
                continue  # stale slot; keep probing
            # uncompressed (possibly inverted): it is slot's own line
            if slot == lane:
                d = raw.copy()
                if st == LineStatus.MAYBE_INVERTED and self.lit.contains(sa):
                    d = invert_line(d)
                found[lane] = d
                level = 0
                break
            continue  # someone else's uncompressed line -> mispredict
        else:
            raise AssertionError(
                f"CRAM protocol failed to locate line {addr} (probe chain "
                "exhausted) — memory image corrupt"
            )

        if predicted is not None:
            # one-access success metric of Fig. 14
            self.llp.record_outcome(probes == 1)
        self.llp.update(addr, level)
        self.stats.demand_reads += 1
        self.stats.read_probes += probes
        return found, level, probes

    # ------------------------------------------------------------------ evict
    def _prior_state_from_levels(self, e: GroupEntry) -> int:
        """Reconstruct the group's memory layout from the LLC 2-bit tags."""
        from ..compression.layouts import S_QUAD, fits_to_state

        lv = [e.levels[l] if e.valid_mask & (1 << l) else -1 for l in range(4)]
        if 2 in lv:
            return S_QUAD
        ab = lv[0] == 1 or lv[1] == 1
        cd = lv[2] == 1 or lv[3] == 1
        return fits_to_state(ab, cd, False)

    def _evict(self, e: GroupEntry) -> None:
        group = e.group
        valid, dirty = e.valid_mask, e.dirty_mask & e.valid_mask
        sampled = self.llc.is_sampled(group)
        drive_counter = sampled and self.policy == "dynamic"
        enabled = self._compression_enabled_for(group)

        prior = self._prior_state_from_levels(e)
        if enabled:
            sizes = [LINE_BYTES + 1] * 4
            for lane in range(4):
                if valid & (1 << lane):
                    sizes[lane] = len(cc.compress_line(e.data[lane]))
            fits_ab = sizes[0] + sizes[1] <= PAYLOAD_BUDGET
            fits_cd = sizes[2] + sizes[3] <= PAYLOAD_BUDGET
            fits_quad = sum(sizes) <= PAYLOAD_BUDGET
        else:
            fits_ab = fits_cd = fits_quad = False

        plan = evict_plan(
            prior, fits_ab, fits_cd, fits_quad, valid, dirty, enabled,
            self.compress_clean,
        )

        for slot, lanes, packed, has_dirty in plan.writes:
            sa = self._slot_addr(group, slot)
            if not packed:
                self._write_uncompressed_slot(sa, e.data[lanes[0]])
            else:
                marker = (
                    self.spec.marker4(sa) if len(lanes) == 4
                    else self.spec.marker2(sa)
                )
                blob = cc.pack_group([e.data[l] for l in lanes], marker)
                assert blob is not None, "evict_plan admitted an unpackable group"
                self.mem[sa] = blob
                self.lit.remove(sa)
            if has_dirty:
                self.stats.wb_dirty += 1
            else:
                self.stats.wb_clean += 1
                if drive_counter:
                    self.dyn.cost()

        for slot in plan.il_slots:
            sa = self._slot_addr(group, slot)
            self.mem[sa] = np.frombuffer(self.spec.marker_il(sa), dtype=np.uint8)
            self.lit.remove(sa)
            self.stats.il_writes += 1
            if drive_counter:
                self.dyn.cost()

        # eviction is also a compressibility observation for the LCT
        for lane in range(4):
            if valid & (1 << lane):
                self.llp.update(
                    group * 4 + lane, int(LANE_LEVEL[plan.new_state][lane])
                )

    # ----------------------------------------------------------------- access
    def access(self, addr: int, is_write: bool = False,
               data: np.ndarray | None = None) -> np.ndarray:
        """One CPU access at 64B-line granularity. Returns the line's value."""
        assert 0 <= addr < self.n_lines
        group, lane = addr // 4, addr % 4
        bit = 1 << lane
        e = self.llc.lookup(group)
        if e is not None and e.valid_mask & bit:
            self.stats.llc_hits += 1
            self.llc.touch(e)
            if e.pf_mask & bit:  # a free prefetch proved useful (benefit)
                e.pf_mask &= ~bit
                self.stats.prefetch_used += 1
                if self.llc.is_sampled(group) and self.policy == "dynamic":
                    self.dyn.benefit()
            if is_write:
                e.data[lane] = data
                e.dirty_mask |= bit
            return e.data[lane].copy()

        self.stats.llc_misses += 1
        found, level, _ = self._fetch(addr)
        entry = GroupEntry(group=group)
        for l, v in found.items():
            entry.valid_mask |= 1 << l
            entry.levels[l] = level
            entry.data[l] = v
            if l != lane:
                entry.pf_mask |= 1 << l
                self.stats.prefetch_installed += 1
        victim = self.llc.install(entry)
        if victim is not None:
            self._evict(victim)
        e = self.llc.lookup(group)
        if is_write:
            e.data[lane] = data
            e.dirty_mask |= bit
        self.llc.touch(e)
        return e.data[lane].copy()

    def flush(self) -> None:
        """Evict everything (used by tests to force memory round-trips)."""
        for e in list(self.llc.entries()):
            self.llc.remove(e)
            self._evict(e)

    def total_mem_accesses(self) -> int:
        return self.stats.total_mem_accesses(self.lit.extra_accesses)
