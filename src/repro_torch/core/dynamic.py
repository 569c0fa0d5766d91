"""Moved: repro_torch.compression.gate is the implementation (THE Dynamic-CRAM
saturating-counter cost/benefit gate, §VI)."""

from ..compression.gate import (  # noqa: F401
    COUNTER_BITS,
    COUNTER_INIT,
    COUNTER_MAX,
    ENABLE_THRESHOLD,
    SAMPLE_RATE,
    DynamicController,
    counter_enabled,
    counter_step,
    is_sampled_set,
)
