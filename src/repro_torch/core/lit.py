"""Line Inversion Table (LIT) — §V-A (a copy of `repro.core.lit`).

Tracks the (rare) lines stored inverted because their raw bytes collide with
a marker value.  16 entries of {valid, 30-bit line address} = 64B on-chip.

Overflow handling (paper's two options):
  * Option-1: a memory-mapped inversion bitmap (1 bit per line in memory);
    while in use, resolving a suspected inversion costs one extra memory
    access (worst case 2x bandwidth under adversarial data).
  * Option-2: regenerate marker keys and re-encode memory (callback).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class LIT:
    capacity: int = 16
    overflow_policy: str = "memory_mapped"  # or "regenerate"
    entries: set = field(default_factory=set)
    # memory-mapped overflow bitmap (line_addr -> inverted?)
    overflow_map: set = field(default_factory=set)
    overflowed: bool = False
    overflow_events: int = 0
    extra_accesses: int = 0  # bandwidth cost of memory-mapped lookups

    def would_overflow(self, line_addr: int) -> bool:
        if line_addr in self.entries or line_addr in self.overflow_map:
            return False
        return len(self.entries) >= self.capacity or self.overflowed

    def insert(self, line_addr: int, regenerate_cb=None) -> None:
        if line_addr in self.entries or line_addr in self.overflow_map:
            return
        if len(self.entries) < self.capacity and not self.overflowed:
            self.entries.add(line_addr)
            return
        # Paper Option-1: spill to the memory-mapped bitmap.  (Option-2,
        # marker regeneration, is orchestrated by the controller *before*
        # the colliding write lands — see CRAMSystem._write_uncompressed_slot.)
        self.overflow_events += 1
        self.overflowed = True
        self.overflow_map.add(line_addr)
        self.extra_accesses += 1  # write of the bitmap line

    def remove(self, line_addr: int) -> None:
        self.entries.discard(line_addr)
        if line_addr in self.overflow_map:
            self.overflow_map.discard(line_addr)
            self.extra_accesses += 1

    def contains(self, line_addr: int) -> bool:
        if line_addr in self.entries:
            return True
        if self.overflowed:
            # suspected-inversion check hits the in-memory bitmap
            self.extra_accesses += 1
            return line_addr in self.overflow_map
        return False

    @property
    def storage_bytes(self) -> int:
        # valid bit + 30-bit address per entry, rounded to the paper's 64B
        return self.capacity * 4


def years_to_overflow(write_rate_per_s: float = 1e9, capacity: int = 16,
                      marker_bits: int = 32) -> float:
    """Back-of-envelope reproduction of the paper's '10 million years' claim:
    expected concurrent inversions ~ Binomial(N_lines, 2^-31); the time for
    >capacity lines to *concurrently* collide under continuous writes is
    astronomically long.  We reproduce the order of magnitude by computing the
    expected wait for `capacity+1` collisions within one memory's worth of
    lines, assuming one collision outstanding per 2^31 writes.
    """
    p = 2.0 * 2.0 ** (-marker_bits)
    writes_per_collision = 1.0 / p
    # need capacity+1 simultaneous: geometric compounding (coarse bound)
    writes_needed = writes_per_collision ** 1  # per-collision arrival
    seconds = writes_needed / write_rate_per_s
    # probability all 16 others concurrently present ~ (N*p)^16 -> dominates
    return seconds * (1.0 / max((16e9 / 64 * p), 1e-30)) ** capacity / 3.15e7
