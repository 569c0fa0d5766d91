"""The §VI saturating-counter gate (copy of the parts of
`repro.compression.gate` the port runs): one 12-bit counter whose MSB
gates compression; it starts enabled with a margin.  The KV cache keeps
one counter per sequence on the device; the AutoTuner keeps one per
decision key on the host (`counter_step` / `counter_enabled`)."""

from __future__ import annotations

COUNTER_BITS = 12
COUNTER_MAX = (1 << COUNTER_BITS) - 1
ENABLE_THRESHOLD = 1 << (COUNTER_BITS - 1)
COUNTER_INIT = ENABLE_THRESHOLD + 128


def counter_step(counter, cost, benefit, xp):
    """Saturating update: counter + benefit - cost, clipped to
    [0, COUNTER_MAX] with `xp.clip` (numpy in the AutoTuner)."""
    c = counter + benefit - cost
    return xp.clip(c, 0, COUNTER_MAX)


def counter_enabled(counter):
    """The counter's MSB: compression is on."""
    return counter >= ENABLE_THRESHOLD
