"""repro_torch.core — the trace-simulation layer, port of `repro.core`.

The codec/layout/mechanism stack lives in `repro_torch.compression`; this
package keeps the simulation models consuming it:
  * cram (exact functional compressed memory, numpy), llc (group LLC), lit
    (inversion table), evict_logic (layout transitions)
  * engine (the one trace-sim step/state/stats definition; the step runs
    as the CUDA kernel E1 on the card, `kernels/engine_scan.py`), schemes
    (declarative scheme registry), memsim (scalar front-end), batchsim
    (batched scheme x config x workload sweep), traces (workload suite)

The historical codec/mechanism module names (fpc, bdi, compress, marker,
mapping, llp, dynamic, bits) remain importable as re-export shims.
"""

from . import bdi, compress, dynamic, engine, evict_logic, fpc, lit, llc, llp
from . import bits, mapping, marker, schemes, traces
from .batchsim import sweep, sweep_workloads
from .cram import CRAMStats, CRAMSystem
from .engine import N_STATS, STAT_NAMES  # single definition, engine-owned
from .engine import (
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
)
from .memsim import SCHEMES, SimConfig, run_workload, simulate, speedup
from .schemes import Scheme

__all__ = [
    "bdi", "bits", "compress", "dynamic", "engine", "evict_logic", "fpc",
    "lit", "llc", "llp", "mapping", "marker", "schemes", "traces",
    "CRAMSystem", "CRAMStats",
    "Scheme", "SCHEMES", "SimConfig", "run_workload", "simulate", "speedup",
    "sweep", "sweep_workloads", "N_STATS", "STAT_NAMES",
    "ST_READ_PROBES", "ST_DEMAND_READS", "ST_WB_DIRTY", "ST_WB_CLEAN",
    "ST_IL_WRITES", "ST_META_READS", "ST_META_WB", "ST_META_HITS",
    "ST_PF_INSTALLED", "ST_PF_USED", "ST_PRED_TOTAL", "ST_PRED_HIT",
    "ST_LLC_HITS", "ST_LLC_MISSES", "ST_PF_EXTRA_ACCESS",
]
