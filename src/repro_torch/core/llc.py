"""Group-granular last-level cache model with ganged fill/eviction (§V-A),
a copy of `repro.core.llc`.

CRAM's ganged-eviction rule guarantees that all members of a compressed group
are simultaneously present or absent in the LLC, which lets us model the LLC
at the granularity of 4-line groups: one entry = one group, with per-lane
valid/dirty/prefetch bits and the 2-bit prior-compressibility level the paper
stores in the LLC tag store.

Sets are indexed by group id (all four lanes co-locate in one set, the
arrangement ganged eviction requires — noted in DESIGN.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..compression.gate import is_sampled_set


@dataclass
class GroupEntry:
    group: int
    valid_mask: int = 0      # lanes with data present
    dirty_mask: int = 0      # lanes modified since fill
    pf_mask: int = 0         # lanes installed as free prefetches (not demanded)
    levels: list = field(default_factory=lambda: [0, 0, 0, 0])
    data: np.ndarray = None  # (4, 64) uint8
    lru: int = 0

    def __post_init__(self):
        if self.data is None:
            self.data = np.zeros((4, 64), dtype=np.uint8)


class GroupLLC:
    """Set-associative, LRU, group-granular cache."""

    def __init__(self, n_sets: int = 2048, ways: int = 4):
        self.n_sets = n_sets
        self.ways = ways
        self.sets: list[list[GroupEntry]] = [[] for _ in range(n_sets)]
        self._clock = 0

    def set_of(self, group: int) -> int:
        return group % self.n_sets

    def is_sampled(self, group: int) -> bool:
        return bool(is_sampled_set(self.set_of(group), self.n_sets))

    def lookup(self, group: int) -> GroupEntry | None:
        for e in self.sets[self.set_of(group)]:
            if e.group == group:
                return e
        return None

    def touch(self, entry: GroupEntry) -> None:
        self._clock += 1
        entry.lru = self._clock

    def install(self, entry: GroupEntry) -> GroupEntry | None:
        """Insert/merge an entry; returns the victim evicted to make room."""
        s = self.sets[self.set_of(entry.group)]
        existing = self.lookup(entry.group)
        if existing is not None:
            # merge newly fetched lanes into the resident entry
            for lane in range(4):
                bit = 1 << lane
                if entry.valid_mask & bit and not existing.valid_mask & bit:
                    existing.valid_mask |= bit
                    existing.pf_mask |= entry.pf_mask & bit
                    existing.levels[lane] = entry.levels[lane]
                    existing.data[lane] = entry.data[lane]
            self.touch(existing)
            return None
        victim = None
        if len(s) >= self.ways:
            victim = min(s, key=lambda e: e.lru)
            s.remove(victim)
        s.append(entry)
        self.touch(entry)
        return victim

    def remove(self, entry: GroupEntry) -> None:
        self.sets[self.set_of(entry.group)].remove(entry)

    def entries(self):
        for s in self.sets:
            yield from list(s)

    @property
    def capacity_lines(self) -> int:
        return self.n_sets * self.ways * 4
