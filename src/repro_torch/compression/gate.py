"""The §VI saturating-counter gate constants (copy of
`repro.compression.gate`): one 12-bit counter per sequence whose MSB
gates compression; it starts enabled with a margin."""

from __future__ import annotations

COUNTER_BITS = 12
COUNTER_MAX = (1 << COUNTER_BITS) - 1
ENABLE_THRESHOLD = 1 << (COUNTER_BITS - 1)
COUNTER_INIT = ENABLE_THRESHOLD + 128
