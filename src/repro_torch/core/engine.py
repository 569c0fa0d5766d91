"""The trace-simulation engine (step, state, stats), port of
`repro.core.engine`.

Both simulator front-ends are thin adapters over this module:

  * memsim.simulate — the 1x1 instantiation: one scheme row, one trace;
  * batchsim.sweep  — S scheme rows x W workloads in one call.

A scheme is a point in a small design space: `flags` are int32 behaviour
gates (FLAG_*), `params` int32 config values the step reads as data
(PARAM_*), so config-axis sweeps (LCT size, sampling threshold, counter
init, metadata sets) run in the same call as the scheme axis.

Where the reference vmaps a per-lane step, the port writes the lane axis
out: the carry has leading dims (S, W), one lane per (scheme row,
workload).  `run_chunk` advances it over one time slice of the traces
through `kernels.engine_scan` — the CUDA kernel E1 on the card, one launch
per chunk, or its plain PyTorch version on the CPU — in place (the
reference returns a new carry).  Chunked runs are bit-identical to one
run: the scan is sequential either way.

Exactness contract: every stat counter and every carry tensor equal the
reference's for the same inputs (tests/test_torch_engine.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..compression.gate import COUNTER_INIT, COUNTER_MAX, ENABLE_THRESHOLD
from ..compression.layouts import GROUP4, LANE_LEVEL, LANES_IN_SLOT, LOC
from ..compression.predictor import (
    HASH_MULT,
    LCT_ENTRIES,
    LINES_PER_PAGE,
    probe_count_table,
)
from ..device import resolve_device
from ..kernels.engine_scan import (  # the layouts' one definition
    FLAG_COMP,
    FLAG_DYNAMIC,
    FLAG_IDEAL,
    FLAG_LCT_UPDATE,
    FLAG_LLP,
    FLAG_META,
    FLAG_NEXTLINE,
    N_FLAGS,
    N_PARAMS,
    N_STATS,
    PARAM_COUNTER_INIT,
    PARAM_LCT_SIZE,
    PARAM_META_SETS,
    PARAM_SAMPLE_THRESH,
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
    engine_scan,
    fetch_checked,
    raise_refused,
)
from .evict_logic import build_evict_table

STAT_NAMES = (
    "read_probes", "demand_reads", "wb_dirty", "wb_clean", "il_writes",
    "meta_reads", "meta_wb", "meta_hits", "pf_installed", "pf_used",
    "pred_total", "pred_hit", "llc_hits", "llc_misses", "pf_extra_access",
)


def sample_threshold(rate: float) -> int:
    """gate.is_sampled_set's per-1024 threshold as an int param."""
    return max(1, int(rate * 1024))


def default_params(cfg: "SimConfig") -> tuple[int, int, int, int]:
    """The params row of the paper's fixed configuration."""
    return (LCT_ENTRIES, sample_threshold(cfg.sample_rate), COUNTER_INIT,
            cfg.meta_sets)


@dataclass(frozen=True)
class SimConfig:
    # The paper's 8MB LLC scaled with the footprint cap: 128 sets x 8 ways x
    # 4 lanes x 64B = 256KB against a <=64MB footprint.
    llc_sets: int = 128
    llc_ways: int = 8
    n_groups: int = 1 << 18       # matches traces.GROUPS_TOTAL
    meta_sets: int = 64           # 32KB metadata cache: 64 sets x 8 ways x 64B
    meta_ways: int = 8
    groups_per_meta: int = 128    # ~170 groups per 64B metadata line; pow2
    compress_clean: bool = True
    sample_rate: float = 0.08     # scaled from the paper's 1% (trace-length)


def _probe_count_table() -> np.ndarray:
    """PROBE[state, lane, predicted_level] for the GROUP4 layout."""
    return probe_count_table(GROUP4)


def _set_hash_table(n_sets: int) -> np.ndarray:
    """(set * PHI) mod 1024 per LLC set; compared against
    PARAM_SAMPLE_THRESH it reproduces gate.is_sampled_set bit for bit with
    the sampling rate as data."""
    h = (np.arange(n_sets, dtype=np.uint64) * HASH_MULT) & 0xFFFFFFFF
    return (h % 1024).astype(np.int32)


def engine_tables(cfg: SimConfig) -> dict:
    """The step's lookup tables as int32 numpy arrays, by the names
    `kernels.engine_scan` takes: the eviction table's four columns,
    PROBE, LOC, LANES_IN_SLOT, LANE_LEVEL and SET_HASH."""
    tables = dict(build_evict_table(cfg.compress_clean))
    tables.update(probe=_probe_count_table(), loc=LOC,
                  lanes_in_slot=LANES_IN_SLOT, lane_level=LANE_LEVEL,
                  set_hash=_set_hash_table(cfg.llc_sets))
    return {k: np.ascontiguousarray(v, dtype=np.int32)
            for k, v in tables.items()}


def engine_consts(cfg: SimConfig) -> dict:
    """The step's scalar constants (`kernels.engine_scan.CONST_NAMES`)."""
    return {"enable_threshold": ENABLE_THRESHOLD, "counter_max": COUNTER_MAX,
            "hash_mult": HASH_MULT, "lines_per_page": LINES_PER_PAGE,
            "groups_per_meta": cfg.groups_per_meta}


@dataclass(frozen=True)
class EngineParts:
    """The three engine entry points for one SimConfig.

    init_state(params, n_workloads=1, *, device="cuda") -> carry tuple
    run_chunk(carry, flags, params, *trace, err=None)
                                  -> (carry updated in place, refusal flags)
    run_one(flags, params, *trace)           -> (S, W, N_STATS) int32 stats

    flags (S, N_FLAGS) and params (S, N_PARAMS) are per scheme row; the
    trace is addrs / is_write (W, T) and the fit bitmaps pair_ab /
    pair_cd / quad (W, n_groups), all tensors on the carry's device.
    """
    init_state: callable
    run_chunk: callable
    run_one: callable


@functools.lru_cache(maxsize=None)
def device_tables(cfg: SimConfig, device: torch.device) -> dict:
    """`engine_tables` as int32 tensors on `device`, made once."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in engine_tables(cfg).items()}


@functools.lru_cache(maxsize=None)
def build_engine(cfg: SimConfig) -> EngineParts:
    sets, ways = cfg.llc_sets, cfg.llc_ways
    ms, mw = cfg.meta_sets, cfg.meta_ways
    consts = engine_consts(cfg)

    def init_state(params, n_workloads: int = 1, *, device="cuda"):
        """The zero state of every lane, the counter at each row's
        PARAM_COUNTER_INIT.  `params` is (S, N_PARAMS) (or one row)."""
        dev = resolve_device(device)
        pr = torch.as_tensor(params, dtype=torch.int32).reshape(-1, N_PARAMS)
        lead = (pr.shape[0], n_workloads)

        def z(*shape, dtype=torch.int32):
            return torch.zeros(lead + shape, dtype=dtype, device=dev)

        counter = pr[:, PARAM_COUNTER_INIT].to(dev)[:, None].expand(
            lead).contiguous()
        return (z(sets, ways), z(sets, ways), z(sets, ways), z(sets, ways),
                z(sets, ways),
                z(cfg.n_groups, dtype=torch.int8),     # mem_state (all S_U)
                z(LCT_ENTRIES, dtype=torch.int8),      # lct
                (z(ms, mw), z(ms, mw), z(ms, mw, dtype=torch.bool), z()),
                counter,                               # dyn counter
                z(),                                   # clock
                z(N_STATS))

    def run_chunk(carry, flags, params, addrs, is_write, pair_ab, pair_cd,
                  quad, *, err=None):
        """Advance every lane over addrs[:, :] in place (one E1 launch on
        the card, which does not wait for it); returns (carry, err), err
        the launch's refusal flags (`kernels.engine_scan.engine_scan`)."""
        dev = carry[0].device
        flags = torch.as_tensor(flags, dtype=torch.int32, device=dev)
        params = torch.as_tensor(params, dtype=torch.int32, device=dev)
        return engine_scan(carry, flags.reshape(-1, N_FLAGS),
                           params.reshape(-1, N_PARAMS), addrs, is_write,
                           pair_ab, pair_cd, quad, device_tables(cfg, dev),
                           consts, err=err)

    def run_one(flags, params, addrs, is_write, pair_ab, pair_cd, quad):
        carry = init_state(params, addrs.shape[0], device=addrs.device)
        carry, err = run_chunk(carry, flags, params, addrs, is_write,
                               pair_ab, pair_cd, quad)
        raise_refused([err])
        return carry[-1]

    return EngineParts(init_state=init_state, run_chunk=run_chunk,
                       run_one=run_one)


def trace_tensors(cfg: SimConfig, addrs, is_write, pair_ab, pair_cd, quad,
                  device) -> tuple:
    """The trace (W, T) and fit bitmaps (W, n_groups) as contiguous int32 /
    bool tensors on `device` (numpy arrays or tensors in).  Addresses on
    the host are checked here to lie in [0, 4 * n_groups), the range the
    step indexes; a trace already on the card is checked by E1 as it
    runs."""
    def tensor(x, np_dtype, dtype):
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np_dtype))
        return x.to(device=device, dtype=dtype).contiguous()

    if not torch.is_tensor(addrs) or addrs.device.type == "cpu":
        a_host = np.asarray(addrs.cpu() if torch.is_tensor(addrs) else addrs)
        if a_host.size and (a_host.min() < 0
                            or a_host.max() >= 4 * cfg.n_groups):
            raise ValueError(f"trace addresses must lie in [0, "
                             f"{4 * cfg.n_groups}) for n_groups = "
                             f"{cfg.n_groups}")
    a = tensor(addrs, np.int32, torch.int32)
    w = tensor(is_write, np.bool_, torch.bool)
    fits = tuple(tensor(x, np.bool_, torch.bool)
                 for x in (pair_ab, pair_cd, quad))
    if a.dim() != 2 or tuple(w.shape) != tuple(a.shape):
        raise ValueError(f"addrs and is_write must be (W, T) alike, got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    for f in fits:
        if tuple(f.shape) != (a.shape[0], cfg.n_groups):
            raise ValueError(f"fit bitmaps must be (W, {cfg.n_groups}), got "
                             f"{tuple(f.shape)}")
    return (a, w) + fits


def launch_trace(cfg: SimConfig, flags, params, addrs, is_write, pair_ab,
                 pair_cd, quad, *, chunk_size: int | None = None,
                 device="cuda") -> tuple:
    """Every scheme row over every workload: S x W lanes from the zero
    state, the whole trace in one `run_chunk` (one E1 launch on the
    card), or `chunk_size` events at a time with the same carry, the
    chunks enqueued back to back with one set of refusal flags.  Returns
    (carry, err) without waiting for the card: the carry's last entry is
    the (S, W, N_STATS) stats, and a caller that returns a result reads
    `err` with it (`fetch_checked` / `raise_refused`)."""
    dev = resolve_device(device)
    eng = build_engine(cfg)
    a, w, pab, pcd, pq = trace_tensors(cfg, addrs, is_write, pair_ab,
                                       pair_cd, quad, dev)
    flags = torch.as_tensor(flags, dtype=torch.int32, device=dev)
    params = torch.as_tensor(params, dtype=torch.int32, device=dev)
    carry = eng.init_state(params, a.shape[0], device=dev)
    err = None
    step = chunk_size or max(a.shape[1], 1)
    for lo in range(0, a.shape[1], step):
        carry, err = eng.run_chunk(carry, flags, params, a[:, lo:lo + step],
                                   w[:, lo:lo + step], pab, pcd, pq, err=err)
    return carry, err


def run_trace(cfg: SimConfig, flags, params, addrs, is_write, pair_ab,
              pair_cd, quad, *, chunk_size: int | None = None,
              device="cuda") -> tuple:
    """`launch_trace`, then its refusal flags read: raises ValueError for
    a refused input, else returns the final carry."""
    carry, err = launch_trace(cfg, flags, params, addrs, is_write, pair_ab,
                              pair_cd, quad, chunk_size=chunk_size,
                              device=device)
    raise_refused([err])
    return carry


__all__ = [
    "ST_READ_PROBES", "ST_DEMAND_READS", "ST_WB_DIRTY", "ST_WB_CLEAN",
    "ST_IL_WRITES", "ST_META_READS", "ST_META_WB", "ST_META_HITS",
    "ST_PF_INSTALLED", "ST_PF_USED", "ST_PRED_TOTAL", "ST_PRED_HIT",
    "ST_LLC_HITS", "ST_LLC_MISSES", "ST_PF_EXTRA_ACCESS", "N_STATS",
    "STAT_NAMES",
    "FLAG_COMP", "FLAG_LLP", "FLAG_META", "FLAG_NEXTLINE", "FLAG_IDEAL",
    "FLAG_DYNAMIC", "FLAG_LCT_UPDATE", "N_FLAGS",
    "PARAM_LCT_SIZE", "PARAM_SAMPLE_THRESH", "PARAM_COUNTER_INIT",
    "PARAM_META_SETS", "N_PARAMS",
    "SimConfig", "EngineParts", "build_engine", "default_params",
    "sample_threshold", "engine_tables", "engine_consts", "device_tables",
    "trace_tensors", "fetch_checked", "raise_refused",
    "launch_trace", "run_trace",
]
