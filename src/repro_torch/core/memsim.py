"""Scalar trace-driven bandwidth simulator — the engine's 1x1 instantiation
(port of `repro.core.memsim`).

The step, state and stat layout live in `core.engine`; scheme semantics in
the `core.schemes` registry.  `simulate` runs one scheme row over one
trace as one lane through the same wrapper as the batched sweep (one E1
launch on the card, or one per chunk with `chunk_size`).

Schemes (see schemes.py):
  baseline   — uncompressed memory (the normalization target)
  nextline   — uncompressed + next-line prefetch on miss (Table V)
  ideal      — compression benefits with zero maintenance overheads
  explicit   — CRAM with explicit metadata + 32KB metadata cache
  cram       — CRAM + implicit metadata + LLP, always compress
  dynamic    — Dynamic-CRAM with set sampling + 12-bit counter

Performance model: speedup = 1/((1-f) + f·ratio) with f the workload's
memory-bound fraction and ratio = scheme_accesses/baseline_accesses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..device import resolve_device
from . import schemes as schemes_registry
from .engine import (  # noqa: F401  (stat indices re-exported for callers)
    N_STATS,
    ST_DEMAND_READS,
    ST_IL_WRITES,
    ST_LLC_HITS,
    ST_LLC_MISSES,
    ST_META_HITS,
    ST_META_READS,
    ST_META_WB,
    ST_PF_EXTRA_ACCESS,
    ST_PF_INSTALLED,
    ST_PF_USED,
    ST_PRED_HIT,
    ST_PRED_TOTAL,
    ST_READ_PROBES,
    ST_WB_CLEAN,
    ST_WB_DIRTY,
    STAT_NAMES,
    SimConfig,
    fetch_checked,
    launch_trace,
)
from .schemes import BASE_SCHEMES as SCHEMES


@dataclass
class SimResult:
    scheme: str
    stats: dict
    accesses: int
    llp_accuracy: float
    meta_hit_rate: float

    def bandwidth_breakdown(self) -> dict:
        s = self.stats
        return {
            "data_reads": s["demand_reads"],
            "mispredict_extra": s["read_probes"] - s["demand_reads"],
            "wb_dirty": s["wb_dirty"],
            "wb_clean+invalidate": s["wb_clean"] + s["il_writes"],
            "metadata": s["meta_reads"] + s["meta_wb"],
            "prefetch_extra": s["pf_extra_access"],
        }


def summarize_stats(scheme: str, stats_vec) -> SimResult:
    """Fold a raw N_STATS vector into a SimResult (shared with batchsim)."""
    stats = dict(zip(STAT_NAMES, (int(x) for x in np.asarray(stats_vec)),
                     strict=True))
    accesses = (
        stats["read_probes"] + stats["wb_dirty"] + stats["wb_clean"]
        + stats["il_writes"] + stats["meta_reads"] + stats["meta_wb"]
        + stats["pf_extra_access"]
    )
    llp_acc = (
        stats["pred_hit"] / stats["pred_total"] if stats["pred_total"] else 1.0
    )
    meta_tot = stats["meta_hits"] + stats["meta_reads"]
    meta_hr = stats["meta_hits"] / meta_tot if meta_tot else 1.0
    return SimResult(scheme, stats, accesses, llp_acc, meta_hr)


def simulate(scheme, addrs, is_write, pair_ab, pair_cd, quad,
             cfg: SimConfig = SimConfig(), chunk_size: int | None = None,
             *, device="cuda") -> SimResult:
    """Run one scheme over one trace.  `scheme` is a registry name or a
    schemes.Scheme record; `chunk_size` runs the trace as a loop of
    chunks over one carry (bit-identical to one run)."""
    dev = resolve_device(device)
    sch = schemes_registry.resolve(scheme)
    carry, err = launch_trace(
        cfg, sch.flags()[None], sch.params(cfg)[None],
        np.asarray(addrs)[None], np.asarray(is_write)[None],
        np.asarray(pair_ab)[None], np.asarray(pair_cd)[None],
        np.asarray(quad)[None], chunk_size=chunk_size, device=dev)
    return summarize_stats(sch.name, fetch_checked(carry[-1][0, 0], [err]))


def speedup(baseline_accesses: int, scheme_accesses: int, f: float) -> float:
    ratio = scheme_accesses / max(baseline_accesses, 1)
    return 1.0 / ((1.0 - f) + f * ratio)


def summarize_workload(name: str, f: float, results: dict[str, SimResult],
                       baseline_accesses: int) -> dict:
    """Per-workload summary dict (shared between the scalar and batched
    front-ends so their reports are field-for-field comparable); each
    scheme's STAT counters also land as ledger rows ("traffic",
    `bandwidth.adapters.engine_traffic`)."""
    from ..bandwidth.adapters import engine_traffic

    summary = {
        sch: {
            "accesses": r.accesses,
            "speedup": speedup(baseline_accesses, r.accesses, f),
            "llp_accuracy": r.llp_accuracy,
            "meta_hit_rate": r.meta_hit_rate,
            "breakdown": r.bandwidth_breakdown(),
            "traffic": engine_traffic(r.stats).as_dict(),
        }
        for sch, r in results.items()
    }
    return {"workload": name, "f": f,
            "baseline_accesses": baseline_accesses, "schemes": summary}


def run_workload(name: str, schemes=SCHEMES, n_events: int = 200_000,
                 seed: int = 0, cfg: SimConfig = SimConfig(), *,
                 device="cuda"):
    """Simulate one workload under several schemes; returns summary dict.

    A baseline run is required for speedup normalization; when "baseline"
    is not among the requested schemes it is run first as well.
    """
    from .traces import build_workload

    dev = resolve_device(device)
    meta, addrs, is_write, pab, pcd, pq, f = build_workload(name, n_events, seed)
    requested = [schemes_registry.resolve(s) for s in schemes]
    req_names = [s.name for s in requested]
    sim_schemes = (requested if "baseline" in req_names
                   else [schemes_registry.get("baseline"), *requested])
    out, base = {}, None
    for sch in sim_schemes:
        res = simulate(sch, addrs, is_write, pab, pcd, pq, cfg, device=dev)
        if sch in requested:
            out[sch.name] = res
        if sch.name == "baseline":
            base = res.accesses
    return summarize_workload(name, f, out, base)
