"""Batched multi-workload x multi-scheme sweep (port of
`repro.core.batchsim`).

  * scheme axis — engine (flags, params) rows stacked to (S, N_FLAGS) /
    (S, N_PARAMS); params are data, so config ablations (LCT size,
    sampling threshold, counter init, metadata sets — schemes.variant) run
    in the same call as behaviour variants;
  * workload axis — traces stacked to (W, T);
  * time axis — `chunk_size` runs the trace as a loop of chunks over one
    carry.

The S x W lanes run in one E1 launch on the card (one per chunk), where
the reference vmaps its step over both axes in one jitted dispatch.  On
one device `shard=True` and `"auto"` run this single-device path, as the
reference does when it finds one device; sharding the workload axis over
several cards is not ported (`shard=True` with several visible cards
raises).  All modes give bit-identical int32 stats.

Entry points:
  sweep(...)            — raw (S, W, N_STATS) stats from stacked traces
  sweep_workloads(...)  — build traces for named workloads, run one batched
                          call, return {name: run_workload-style dict}
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import schemes as schemes_registry
from .engine import N_STATS, SimConfig, run_trace  # noqa: F401
from .memsim import SCHEMES, summarize_stats, summarize_workload


def scheme_flags(schemes) -> np.ndarray:
    """(S, N_FLAGS) int32 flag matrix (back-compat: schemes.flags_matrix)."""
    return schemes_registry.flags_matrix(schemes)


def _check_shard(shard, chunk_size, dev) -> None:
    if chunk_size and shard is True:
        raise ValueError(
            "chunk_size and shard=True cannot be combined; chunked "
            "execution runs the workload axis on one device")
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if shard is True and n_dev > 1:
        raise NotImplementedError(
            f"sharding the sweep's workload axis over {n_dev} cards is not "
            "ported; pass shard=False or 'auto' to run on one card")


def sweep(schemes, addrs, is_write, pair_ab, pair_cd, quad,
          cfg: SimConfig = SimConfig(), *, chunk_size: int | None = None,
          shard: "bool | str" = "auto", device="cuda") -> np.ndarray:
    """Run every scheme x workload pair in one batched call.

    schemes: registry names and/or schemes.Scheme records (the scheme AND
    config axis — variants with different params batch together).
    addrs/is_write: (W, T); pair_ab/pair_cd/quad: (W, n_groups) bool.
    chunk_size: run the trace as a loop of chunks over one carry.
    shard: see the module docstring.

    Returns int32 stats of shape (len(schemes), W, N_STATS), laid out per
    the engine's ST_* indices — bit-identical across execution modes.
    """
    dev = resolve_device(device)
    _check_shard(shard, chunk_size, dev)
    resolved = [schemes_registry.resolve(s) for s in schemes]
    carry = run_trace(cfg, schemes_registry.flags_matrix(resolved),
                      schemes_registry.params_matrix(resolved, cfg),
                      addrs, is_write, pair_ab, pair_cd, quad,
                      chunk_size=chunk_size, device=dev)
    return carry[-1].cpu().numpy()


def stack_workloads(names, n_events: int, seed: int) -> tuple:
    """Build the named workloads (the same generators and seeds as the
    scalar path) and stack them: (metas, fs, addrs, is_write, pair_ab,
    pair_cd, quad), the last five (W, ...) numpy arrays."""
    from .traces import build_workload

    built = [build_workload(name, n_events, seed) for name in names]
    metas = [b[0] for b in built]
    fs = [b[6] for b in built]
    return (metas, fs, *(np.stack([b[i] for b in built])
                         for i in range(1, 6)))


def sweep_workloads(names=None, schemes=SCHEMES, n_events: int = 200_000,
                    seed: int = 0, cfg: SimConfig = SimConfig(), *,
                    chunk_size: int | None = None,
                    shard: "bool | str" = "auto", device="cuda") -> dict:
    """Batched replacement for {name: memsim.run_workload(name)} loops.

    Builds the named traces, stacks them, and runs one batched call
    covering all schemes and workloads.  Returns {name: summary} where
    each summary is field-for-field identical to memsim.run_workload's.
    """
    from .traces import all_workload_names

    dev = resolve_device(device)
    names = list(names) if names is not None else all_workload_names()
    requested = [schemes_registry.resolve(s) for s in schemes]
    req_names = [s.name for s in requested]
    # a baseline run is required for speedup normalization
    sim_schemes = (requested if "baseline" in req_names
                   else [schemes_registry.get("baseline"), *requested])

    _, fs, *trace = stack_workloads(names, n_events, seed)
    stats = sweep(sim_schemes, *trace, cfg, chunk_size=chunk_size,
                  shard=shard, device=dev)

    out = {}
    sim_names = [s.name for s in sim_schemes]
    base_row = sim_names.index("baseline")
    for wi, name in enumerate(names):
        results = {
            sch: summarize_stats(sch, stats[si, wi])
            for si, sch in enumerate(sim_names) if sch in req_names
        }
        base = summarize_stats("baseline", stats[base_row, wi]).accesses
        out[name] = summarize_workload(name, fs[wi], results, base)
    return out
