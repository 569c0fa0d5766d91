"""The traffic ledger and the KV cache's byte adapters (port of the KV
part of `repro.bandwidth`; the AutoTuner comes with the spill tier)."""

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
]
