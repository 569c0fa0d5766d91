"""The §VI saturating-counter gate (copy of the parts of
`repro.compression.gate` the port runs): one 12-bit counter whose MSB
gates compression; it starts enabled with a margin.  The KV cache keeps
one counter per sequence on the device; the AutoTuner keeps one per
decision key on the host (`counter_step` / `counter_enabled`); the trace
engine keeps one per simulated lane, the functional model (`core/cram.py`)
a `DynamicController` over set-sampled LLC events (`is_sampled_set`), and
the compressed-gradient DP step one for the wire (`wire_counter_step`)."""

from __future__ import annotations

import numpy as np

from .framing import FIB_MULT

COUNTER_BITS = 12
COUNTER_MAX = (1 << COUNTER_BITS) - 1
ENABLE_THRESHOLD = 1 << (COUNTER_BITS - 1)
COUNTER_INIT = ENABLE_THRESHOLD + 128
SAMPLE_RATE = 0.01


class DynamicController:
    """Host-side counters, one per core: cost decrements, benefit
    increments, both saturating; the MSB enables compression."""

    def __init__(self, n_cores: int = 1):
        self.counters = np.full(n_cores, COUNTER_INIT, dtype=np.int32)

    def cost(self, n: int = 1, core: int = 0) -> None:
        self.counters[core] = max(0, int(self.counters[core]) - n)

    def benefit(self, n: int = 1, core: int = 0) -> None:
        self.counters[core] = min(COUNTER_MAX, int(self.counters[core]) + n)

    def enabled(self, core: int = 0) -> bool:
        return bool(self.counters[core] >= ENABLE_THRESHOLD)

    @property
    def storage_bytes(self) -> int:
        return self.counters.size * COUNTER_BITS // 8


def is_sampled_set(set_idx, n_sets, rate: float = SAMPLE_RATE):
    """Deterministic ~1% sampling of LLC sets (hash-spread, not
    contiguous); `n_sets` is unused, as in the reference."""
    h = (set_idx * FIB_MULT) & 0xFFFFFFFF
    return (h % 1024) < max(1, int(rate * 1024))


def counter_step(counter, cost, benefit, xp):
    """Saturating update: counter + benefit - cost, clipped to
    [0, COUNTER_MAX] with `xp.clip` (numpy in the AutoTuner)."""
    c = counter + benefit - cost
    return xp.clip(c, 0, COUNTER_MAX)


def counter_enabled(counter):
    """The counter's MSB: compression is on."""
    return counter >= ENABLE_THRESHOLD


# --------------------------------------------------------------- wire gate
# §VI applied to the gradient collective (optim.grad_compress): benefit is
# the fraction of wire bytes the int8 collective saves, cost is a quality
# penalty when the relative quantization error exceeds its budget.
WIRE_BENEFIT_SCALE = 16      # counter ticks per unit fraction of bytes saved
WIRE_COST_OVER_BUDGET = 64   # ticks charged when quality is over budget


def wire_counter_step(counter, bytes_saving: float, over_budget, xp=np):
    """One wire-gate update: `bytes_saving` is the fractional wire-byte
    win (0.75 for float32 -> int8), its benefit the float32 product with
    WIRE_BENEFIT_SCALE truncated to an int, as the reference computes it;
    `over_budget` a bool (numpy, or a tensor with xp=torch)."""
    benefit = int(np.float32(bytes_saving) * np.float32(WIRE_BENEFIT_SCALE))
    cost = xp.where(over_budget, WIRE_COST_OVER_BUDGET, 0)
    return counter_step(counter, cost, benefit, xp)
