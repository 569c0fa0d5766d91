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
the reference vmaps its step over both axes in one jitted dispatch.  With
several devices (`devices`, by default every visible card) the workload
axis is sharded, as the reference's `shard_map` shards it: W splits into
len(devices) equal shards, each one E1 launch on its device with its own
refusal flags, and the stats are gathered in workload order.  A list may
name one card more than once, which is how one card runs the sharded
path.  `shard="auto"` shards when there are several devices and W
divides; `shard=True` asks for it and falls back the same way; False
runs one launch on `device`.  Chunked execution runs on one device, and
`chunk_size` with `shard=True` raises.  No launch waits for the card:
the stats come to the host in one copy with every launch's refusal flags,
and a refused input raises ValueError instead of returning stats.  All
modes give bit-identical int32 stats.

Entry points:
  sweep(...)            — raw (S, W, N_STATS) stats from stacked traces
  sweep_workloads(...)  — build traces for named workloads, run one batched
                          call, return {name: run_workload-style dict}
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_list, on_device, resolve_device
from . import schemes as schemes_registry
from .engine import (  # noqa: F401
    N_STATS,
    SimConfig,
    fetch_checked,
    launch_trace,
)
from .memsim import SCHEMES, summarize_stats, summarize_workload


def scheme_flags(schemes) -> np.ndarray:
    """(S, N_FLAGS) int32 flag matrix (back-compat: schemes.flags_matrix)."""
    return schemes_registry.flags_matrix(schemes)


def sweep(schemes, addrs, is_write, pair_ab, pair_cd, quad,
          cfg: SimConfig = SimConfig(), *, chunk_size: int | None = None,
          shard: "bool | str" = "auto", device="cuda",
          devices=None) -> np.ndarray:
    """Run every scheme x workload pair in one batched call.

    schemes: registry names and/or schemes.Scheme records (the scheme AND
    config axis — variants with different params batch together).
    addrs/is_write: (W, T); pair_ab/pair_cd/quad: (W, n_groups) bool.
    chunk_size: run the trace as a loop of chunks over one carry.
    shard / devices: see the module docstring.

    Returns int32 stats of shape (len(schemes), W, N_STATS), laid out per
    the engine's ST_* indices — bit-identical across execution modes.
    """
    dev = resolve_device(device)
    if chunk_size and shard is True:
        raise ValueError(
            "chunk_size and shard=True cannot be combined; chunked "
            "execution runs the workload axis on one device")
    devs = device_list(devices, dev)
    resolved = [schemes_registry.resolve(s) for s in schemes]
    flags = schemes_registry.flags_matrix(resolved)
    params = schemes_registry.params_matrix(resolved, cfg)
    trace = (addrs, is_write, pair_ab, pair_cd, quad)
    n_w, n_dev = len(addrs), len(devs)
    want = shard is True or (shard == "auto" and n_dev > 1)
    if chunk_size or not want or n_dev <= 1 or n_w % n_dev:
        carry, err = launch_trace(cfg, flags, params, *trace,
                                  chunk_size=chunk_size, device=dev)
        return fetch_checked(carry[-1], [err])
    per = n_w // n_dev
    stats, errs = [], []
    for i, d in enumerate(devs):
        with on_device(d):
            carry, err = launch_trace(
                cfg, flags, params, *(x[i * per:(i + 1) * per]
                                      for x in trace), device=d)
        stats.append(carry[-1])
        errs.append(err)
    return fetch_checked(torch.cat([s.to(devs[0]) for s in stats], dim=1),
                         errs)


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
                    shard: "bool | str" = "auto", device="cuda",
                    devices=None) -> dict:
    """Batched replacement for {name: memsim.run_workload(name)} loops.

    Builds the named traces, stacks them, and runs one batched call
    covering all schemes and workloads.  Returns {name: summary} where
    each summary is field-for-field identical to memsim.run_workload's.
    """
    from .traces import all_workload_names

    dev = resolve_device(device)
    names = list(names) if names is not None else all_workload_names()
    sim_schemes = with_baseline(schemes)
    _, fs, *trace = stack_workloads(names, n_events, seed)
    stats = sweep(sim_schemes, *trace, cfg, chunk_size=chunk_size,
                  shard=shard, device=dev, devices=devices)
    return summarize_sweep(names, fs, schemes, sim_schemes, stats)


def with_baseline(schemes) -> list:
    """The scheme rows a summarised sweep runs: the requested ones, with
    baseline first when it is not among them (speedups are normalised by
    it)."""
    requested = [schemes_registry.resolve(s) for s in schemes]
    if "baseline" in [s.name for s in requested]:
        return requested
    return [schemes_registry.get("baseline"), *requested]


def summarize_sweep(names, fs, schemes, sim_schemes, stats) -> dict:
    """{name: run_workload-style summary} of the requested `schemes` from
    the (len(sim_schemes), W, N_STATS) stats of `sweep(sim_schemes, ...)`
    over the named workloads (`fs`: their fractions, from
    `stack_workloads`)."""
    req_names = [schemes_registry.resolve(s).name for s in schemes]
    sim_names = [s.name for s in sim_schemes]
    base_row = sim_names.index("baseline")
    out = {}
    for wi, name in enumerate(names):
        results = {
            sch: summarize_stats(sch, stats[si, wi])
            for si, sch in enumerate(sim_names) if sch in req_names
        }
        base = summarize_stats("baseline", stats[base_row, wi]).accesses
        out[name] = summarize_workload(name, fs[wi], results, base)
    return out
