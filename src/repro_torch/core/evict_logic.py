"""CRAM eviction-time layout transitions (a copy of
`repro.core.evict_logic`).

Both the exact functional model (cram.py, which executes the plan against a
real memory image) and the trace engine (engine.py and its kernel, which
index the counts tabulated by `build_evict_table`) use `evict_plan`, so
their bandwidth accounting agrees by construction.

Semantics (§IV-A write operation, §V-A invalidation, §VI dynamic policy):
  * packing units are the AB half, the CD half, or the whole quad;
  * a unit may be (re)packed only if all its lanes are cached (ganged
    fill/eviction guarantees packed units are co-resident);
  * with compression enabled, clean lines are packed too iff compress_clean
    (the paper's default — the "bandwidth cost of compression");
  * with compression disabled, dirty data lands uncompressed in home slots
    (unpacking its unit); untouched/clean units keep their prior layout;
  * a slot is written iff its lane-composition changes or it holds dirty
    data; slots vacated by the new layout get a Marker-IL write.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..compression.layouts import (
    LOC,
    S_AB,
    S_AB_CD,
    S_CD,
    S_QUAD,
    fits_to_state,
)

_AB_MASK, _CD_MASK, _ALL = 0b0011, 0b1100, 0b1111


@dataclass(frozen=True)
class EvictPlan:
    new_state: int
    # slots to write: (slot, lanes tuple sorted, packed: bool, dirty: bool)
    writes: tuple = ()
    il_slots: tuple = ()

    @property
    def wb_dirty(self) -> int:
        return sum(1 for w in self.writes if w[3])

    @property
    def wb_clean(self) -> int:
        return sum(1 for w in self.writes if not w[3])

    @property
    def il_count(self) -> int:
        return len(self.il_slots)


def _prior_packed(prior: int) -> tuple[bool, bool, bool]:
    return (
        prior in (S_AB, S_AB_CD) or prior == S_QUAD,
        prior in (S_CD, S_AB_CD) or prior == S_QUAD,
        prior == S_QUAD,
    )


def evict_plan(
    prior: int,
    fits_ab: bool,
    fits_cd: bool,
    fits_quad: bool,
    valid: int,
    dirty: int,
    enabled: bool,
    compress_clean: bool = True,
) -> EvictPlan:
    valid &= _ALL
    dirty &= valid
    if valid == 0:
        return EvictPlan(prior)
    if dirty == 0 and (not enabled or not compress_clean):
        return EvictPlan(prior)  # silent clean drop

    p_ab, p_cd, p_quad = _prior_packed(prior)
    if enabled:
        quad_new = bool(fits_quad) and valid == _ALL
        ab_new = (bool(fits_ab) and (valid & _AB_MASK) == _AB_MASK) or (
            (valid & _AB_MASK) == 0 and p_ab and not p_quad
        )
        cd_new = (bool(fits_cd) and (valid & _CD_MASK) == _CD_MASK) or (
            (valid & _CD_MASK) == 0 and p_cd and not p_quad
        )
    else:
        quad_new = p_quad and not dirty
        ab_new = p_ab and not p_quad and not (dirty & _AB_MASK)
        cd_new = p_cd and not p_quad and not (dirty & _CD_MASK)
    new_state = fits_to_state(ab_new, cd_new, quad_new)

    # slot composition before/after, over valid lanes only
    prior_map: dict[int, set] = {}
    new_map: dict[int, set] = {}
    for lane in range(4):
        if valid & (1 << lane):
            prior_map.setdefault(int(LOC[prior][lane]), set()).add(lane)
            new_map.setdefault(int(LOC[new_state][lane]), set()).add(lane)

    writes = []
    for slot in sorted(new_map):
        lanes = tuple(sorted(new_map[slot]))
        changed = prior_map.get(slot, set()) != set(lanes)
        has_dirty = any(dirty & (1 << l) for l in lanes)
        if changed or has_dirty:
            writes.append((slot, lanes, len(lanes) > 1, has_dirty))
    il_slots = tuple(sorted(set(prior_map) - set(new_map)))
    return EvictPlan(new_state, tuple(writes), il_slots)


def build_evict_table(compress_clean: bool = True):
    """Dense lookup tables for the trace engine's step.

    Index: ((((enabled*5 + prior)*2 + fab)*2 + fcd)*2 + fq)*16 + valid)*16
           + dirty
    Returns dict of numpy arrays: wb_dirty, wb_clean, il, new_state.
    """
    import numpy as np

    n = 2 * 5 * 2 * 2 * 2 * 16 * 16
    wb_d = np.zeros(n, dtype=np.int32)
    wb_c = np.zeros(n, dtype=np.int32)
    il = np.zeros(n, dtype=np.int32)
    ns = np.zeros(n, dtype=np.int32)
    i = 0
    for enabled in range(2):
        for prior in range(5):
            for fab in range(2):
                for fcd in range(2):
                    for fq in range(2):
                        for valid in range(16):
                            for dirty in range(16):
                                p = evict_plan(
                                    prior, fab, fcd, fq, valid, dirty,
                                    bool(enabled), compress_clean,
                                )
                                wb_d[i] = p.wb_dirty
                                wb_c[i] = p.wb_clean
                                il[i] = p.il_count
                                ns[i] = p.new_state
                                i += 1
    return {"wb_dirty": wb_d, "wb_clean": wb_c, "il": il, "new_state": ns}


def evict_table_index(enabled, prior, fab, fcd, fq, valid, dirty):
    """Same flattening as build_evict_table; works on Python ints, numpy
    arrays and torch int tensors."""
    return (
        ((((((enabled * 5 + prior) * 2 + fab) * 2 + fcd) * 2 + fq) * 16)
         + valid) * 16 + dirty
    )
