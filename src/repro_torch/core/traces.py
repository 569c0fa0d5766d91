"""Synthetic workload traces mirroring the paper's Table II suite (a copy
of `repro.core.traces`: the same numpy generators and seeds, so the same
arrays).

Each workload is a physical line-address access stream with controllable
spatial locality (sequential-run statistics), reuse (hot working set),
write fraction, and *page-coherent compressibility* (the property the LLP
exploits: lines within a page tend to have similar compressibility, §V-B).

Footprints are capped at 256 MB of line-address space (scaling note in
DESIGN.md §2.2) — what matters for every mechanism under study is the
footprint/LLC ratio and the locality structure, both preserved.

MPKI per workload is taken from Table II and drives the memory-bound
fraction used by the bandwidth-bound speedup model (DESIGN.md §2.2).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

LINES_TOTAL = 1 << 20          # shared address space: 2^20 lines = 64 MB image
GROUPS_TOTAL = LINES_TOTAL // 4
LINES_PER_PAGE = 64


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    suite: str          # SPEC06 / SPEC17 / GAP / MIX
    mpki: float
    footprint_mb: int   # nominal (Table II); capped to the shared space
    p_seq: float        # probability a segment continues sequentially
    seq_len: int        # mean sequential run length (lines)
    hot_frac: float     # fraction of footprint forming the hot set
    p_hot: float        # probability a jump lands in the hot set (reuse)
    write_frac: float
    p2: float           # fraction of pages whose line-pairs fit 2:1
    p4: float           # fraction of pages that additionally fit 4:1


# Parameters are chosen per suite characteristics: SPEC-FP = streaming +
# compressible; mcf/omnetpp = pointer chasing; libq = extremely compressible;
# GAP = huge footprint, poor locality, poor reuse, modest compressibility.
WORKLOADS: tuple[WorkloadSpec, ...] = (
    WorkloadSpec("fotonik", "SPEC17", 26.2, 6800, 0.90, 24, 0.10, 0.84, 0.30, 0.45, 0.20),
    WorkloadSpec("lbm17",   "SPEC17", 25.5, 3400, 0.92, 32, 0.10, 0.84, 0.35, 0.40, 0.15),
    WorkloadSpec("soplex",  "SPEC06", 23.3, 2100, 0.80, 12, 0.15, 0.82, 0.25, 0.40, 0.18),
    WorkloadSpec("libq",    "SPEC06", 23.1, 418,  0.93, 48, 0.30, 0.9, 0.30, 0.80, 0.60),
    WorkloadSpec("mcf17",   "SPEC17", 22.8, 4400, 0.35, 4,  0.10, 0.72, 0.20, 0.35, 0.10),
    WorkloadSpec("milc",    "SPEC06", 21.9, 3100, 0.88, 20, 0.12, 0.82, 0.30, 0.45, 0.15),
    WorkloadSpec("Gems",    "SPEC06", 17.2, 5800, 0.90, 28, 0.10, 0.84, 0.30, 0.50, 0.20),
    WorkloadSpec("parest",  "SPEC17", 16.4, 465,  0.82, 16, 0.25, 0.85, 0.25, 0.45, 0.15),
    WorkloadSpec("sphinx",  "SPEC06", 11.9, 223,  0.85, 16, 0.30, 0.88, 0.20, 0.40, 0.12),
    WorkloadSpec("leslie",  "SPEC06", 11.9, 861,  0.90, 24, 0.15, 0.84, 0.30, 0.45, 0.15),
    WorkloadSpec("cactu17", "SPEC17", 10.6, 2100, 0.55, 6,  0.08, 0.68, 0.30, 0.40, 0.12),
    WorkloadSpec("omnet17", "SPEC17", 8.6,  1900, 0.45, 5,  0.15, 0.76, 0.30, 0.35, 0.10),
    WorkloadSpec("gcc06",   "SPEC06", 5.8,  205,  0.75, 10, 0.35, 0.88, 0.25, 0.50, 0.20),
    WorkloadSpec("xz",      "SPEC17", 5.7,  943,  0.40, 4,  0.05, 0.58, 0.30, 0.45, 0.15),
    WorkloadSpec("wrf17",   "SPEC17", 5.2,  798,  0.85, 18, 0.20, 0.85, 0.25, 0.45, 0.15),
    WorkloadSpec("bc_twi",  "GAP",    66.6, 9200, 0.15, 2,  0.05, 0.15, 0.15, 0.25, 0.05),
    WorkloadSpec("bc_web",  "GAP",    7.4, 10000, 0.30, 3,  0.08, 0.22, 0.15, 0.30, 0.08),
    WorkloadSpec("cc_twi",  "GAP",   101.8, 6000, 0.12, 2,  0.05, 0.12, 0.15, 0.25, 0.05),
    WorkloadSpec("cc_web",  "GAP",    8.1,  5300, 0.30, 3,  0.08, 0.22, 0.15, 0.30, 0.08),
    WorkloadSpec("pr_twi",  "GAP",   144.8, 8300, 0.10, 2,  0.05, 0.12, 0.20, 0.25, 0.05),
    WorkloadSpec("pr_web",  "GAP",    13.1, 8200, 0.25, 3,  0.08, 0.20, 0.20, 0.30, 0.08),
)

MIXES: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("mix1", ("fotonik", "mcf17")),
    ("mix2", ("libq", "omnet17")),
    ("mix3", ("soplex", "xz")),
    ("mix4", ("milc", "gcc06")),
    ("mix5", ("Gems", "cactu17")),
    ("mix6", ("lbm17", "sphinx")),
)

BY_NAME = {w.name: w for w in WORKLOADS}


def all_workload_names() -> list[str]:
    return [w.name for w in WORKLOADS] + [m[0] for m in MIXES]


def memory_bound_fraction(mpki: float, k: float = 15.0) -> float:
    """Fraction of baseline time that is memory-bandwidth bound."""
    return mpki / (mpki + k)


def _page_levels(n_pages: int, p2: float, p4: float, seed: int) -> np.ndarray:
    """Per-page compressibility level: 2 (quad-able), 1 (pair-able), 0."""
    rng = np.random.default_rng(seed ^ 0xC0FFEE)
    u = rng.random(n_pages)
    return np.where(u < p4, 2, np.where(u < p4 + p2, 1, 0)).astype(np.int8)


def group_fits(spec: WorkloadSpec, seed: int = 0):
    """Static per-group packability (pair_ab, pair_cd, quad) bool arrays."""
    n_pages = LINES_TOTAL // LINES_PER_PAGE
    levels = _page_levels(n_pages, spec.p2, spec.p4, seed)
    g_page = (np.arange(GROUPS_TOTAL) * 4) // LINES_PER_PAGE
    g_level = levels[g_page]
    rng = np.random.default_rng(seed ^ 0xBADF00D)
    noise = rng.random((GROUPS_TOTAL, 3))
    # within a compressible page, ~12% of groups individually fail to fit
    pair_ab = (g_level >= 1) & (noise[:, 0] > 0.12)
    pair_cd = (g_level >= 1) & (noise[:, 1] > 0.12)
    quad = (g_level >= 2) & pair_ab & pair_cd & (noise[:, 2] > 0.15)
    return pair_ab, pair_cd, quad


def generate_trace(spec: WorkloadSpec, n_events: int, seed: int = 0):
    """Build (addrs int32 (T,), is_write bool (T,)) for one workload."""
    # crc32, not hash(): str hashing is salted per process, which made
    # traces (and every cached/golden stats vector) irreproducible across
    # runs.  The stream for a given (name, seed) is now deterministic.
    rng = np.random.default_rng(seed ^ zlib.crc32(spec.name.encode()))
    n_lines = min(int(spec.footprint_mb * (1 << 20) // 64), LINES_TOTAL)
    # hot set: large enough to dwarf the (scaled) LLC, small enough that a
    # few-hundred-k-event trace actually revisits it several times (reuse)
    hot_lines = max(4096, min(int(n_lines * spec.hot_frac), 1 << 14))

    segs_addr, total = [], 0
    # draw segments until we cover n_events; a batch's segments are kept
    # up to the first one whose end reaches n_events, the reference's
    # per-segment loop in a few array operations (the same draws, in the
    # same order)
    while total < n_events:
        batch = max(1024, (n_events - total) // 8)
        lens = rng.geometric(1.0 / max(spec.seq_len, 1), size=batch)
        lens = np.minimum(lens, 256)
        non_seq = rng.random(batch) >= spec.p_seq
        lens = np.where(non_seq, 1, lens)
        in_hot = rng.random(batch) < spec.p_hot
        starts = np.where(
            in_hot,
            rng.integers(0, hot_lines, size=batch),
            rng.integers(0, n_lines, size=batch),
        )
        ends = total + np.cumsum(lens)
        keep = min(int(np.searchsorted(ends, n_events)) + 1, batch)
        lens, starts = lens[:keep], starts[:keep]
        first = np.repeat(np.cumsum(lens) - lens, lens)
        steps = np.arange(first.size, dtype=np.int64) - first
        segs_addr.append((np.repeat(starts, lens) + steps) % n_lines)
        total = int(ends[keep - 1])
    addrs = np.concatenate(segs_addr)[:n_events].astype(np.int32)
    is_write = rng.random(n_events) < spec.write_frac
    return addrs, is_write


def build_workload(name: str, n_events: int = 200_000, seed: int = 0):
    """Returns (spec-like meta, addrs, is_write, pair_ab, pair_cd, quad, f)."""
    if name in BY_NAME:
        spec = BY_NAME[name]
        addrs, is_write = generate_trace(spec, n_events, seed)
        fits = group_fits(spec, seed)
        f = memory_bound_fraction(spec.mpki)
        return spec, addrs, is_write, *fits, f
    mix = dict(MIXES).get(name)
    if mix is None:
        raise KeyError(f"unknown workload {name!r}")
    parts = [build_workload(m, n_events // len(mix), seed + i)
             for i, m in enumerate(mix)]
    # interleave the component streams event-by-event (rate-mode-ish)
    addrs = np.empty(sum(len(p[1]) for p in parts), dtype=np.int32)
    wr = np.empty_like(addrs, dtype=bool)
    k = len(parts)
    for i, p in enumerate(parts):
        # offset each component into its own quarter of the address space
        ofs = (i * (LINES_TOTAL // k)) & ~3
        addrs[i::k] = (p[1] + ofs) % LINES_TOTAL
        wr[i::k] = p[2]
    pa = np.zeros(GROUPS_TOTAL, dtype=bool)
    pc = np.zeros(GROUPS_TOTAL, dtype=bool)
    q = np.zeros(GROUPS_TOTAL, dtype=bool)
    for i, p in enumerate(parts):
        ofs_g = (i * (LINES_TOTAL // k)) // 4
        roll = lambda a: np.roll(a, ofs_g)
        pa |= roll(p[3])
        pc |= roll(p[4])
        q |= roll(p[5])
    mpki = float(np.mean([BY_NAME[m].mpki for m in mix]))
    f = memory_bound_fraction(mpki)
    meta = WorkloadSpec(name, "MIX", mpki, 0, 0, 0, 0, 0, 0, 0, 0)
    return meta, addrs, wr, pa, pc, q, f
