"""The traffic ledger, the byte adapters and the AutoTuner (port of
`repro.bandwidth`; the gradient collective's adapter comes with the slice
that ports that consumer).

  ledger   — typed traffic events with a host accumulator and a device
             accumulator
  adapters — the trace engine's STAT counters as rows (`engine_traffic`,
             `engine_breakdown`); the KV cache's decode, repack and
             spill-crossing rows; checkpoint leaf writes and restores
  autotune — the §VI saturating-counter gate as a policy engine: KV
             packing per tier, checkpoint codec, gradient codec
"""

from .adapters import (
    checkpoint_leaf_event,
    checkpoint_restore_event,
    classify_tensor,
    engine_breakdown,
    engine_traffic,
    grad_wire_event,
    kv_decode_event,
    kv_repack_event,
    kv_spill_event,
)
from .autotune import (
    KV_PACKINGS,
    AutoTuner,
    PolicyChoice,
    kv_expected_bytes_per_page,
    kv_spill_bytes_per_page,
    probe_kv_fit_rates,
)
from .ledger import (
    EV_PROBE,
    EV_READ,
    EV_REPACK,
    EV_SPILL,
    EV_WRITE,
    EVENT_NAMES,
    N_EVENTS,
    Ledger,
    device_record,
    device_totals,
    event_id,
)

__all__ = [
    "Ledger", "device_totals", "device_record", "event_id",
    "EV_READ", "EV_WRITE", "EV_PROBE", "EV_REPACK", "EV_SPILL",
    "N_EVENTS", "EVENT_NAMES",
    "engine_traffic", "engine_breakdown",
    "kv_decode_event", "kv_repack_event", "kv_spill_event",
    "classify_tensor", "checkpoint_leaf_event", "checkpoint_restore_event",
    "grad_wire_event",
    "AutoTuner", "PolicyChoice", "KV_PACKINGS",
    "kv_expected_bytes_per_page", "kv_spill_bytes_per_page",
    "probe_kv_fit_rates",
]
