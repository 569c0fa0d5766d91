"""The traffic ledger: one accounting of every byte the system moves
(port of `repro.bandwidth.ledger`).

Rows accumulate (raw_bytes, compressed_bytes, count) keyed by (consumer,
tensor_class, event): raw is what an uncompressed system would have moved
for the same work, compressed is what actually moved, so `saving()` is the
paper's bandwidth win.

Two accumulation paths:

  * host path — `Ledger.record(...)`: plain Python ints;
  * device path — `device_totals()` / `device_record(...)`: an
    (N_EVENTS, 3) int64 tensor that lives in a cache's state on the device
    and is folded into the host ledger with `Ledger.absorb(...)`.  The
    reference's is int32 and wraps past 2 GiB an event class in a window,
    which one serve step over long sessions passes; the totals are equal
    below that.
"""

from __future__ import annotations

import numpy as np
import torch

# traffic event kinds (stable ids: the device accumulator indexes by them)
EV_READ, EV_WRITE, EV_PROBE, EV_REPACK, EV_SPILL, N_EVENTS = range(6)
EVENT_NAMES = ("read", "write", "probe", "repack", "spill")
_EVENT_BY_NAME = {n: i for i, n in enumerate(EVENT_NAMES)}


def event_id(event) -> int:
    """Accept an EV_* id or an event name; return the stable id."""
    if isinstance(event, str):
        try:
            return _EVENT_BY_NAME[event]
        except KeyError:
            raise KeyError(f"unknown traffic event {event!r}; "
                           f"valid: {EVENT_NAMES}") from None
    e = int(event)
    if not 0 <= e < N_EVENTS:
        raise KeyError(f"event id {e} out of range 0..{N_EVENTS - 1}")
    return e


class Ledger:
    """Host-side traffic accumulator keyed by (consumer, tensor_class, event).

    Rows are created on first record; values are python ints (no overflow).
    A ledger can carry a default consumer so call sites inside one
    subsystem stay terse (`ledger.record(EV_READ, raw=..., compressed=...)`).
    """

    __slots__ = ("consumer", "_rows")

    def __init__(self, consumer: str = "anon"):
        self.consumer = consumer
        # (consumer, tensor_class, event_id) -> [raw, compressed, count]
        self._rows: dict[tuple[str, str, int], list[int]] = {}

    # ------------------------------------------------------------ recording
    def record(self, event, *, raw, compressed=None, count: int = 1,
               tensor_class: str = "default",
               consumer: str | None = None) -> tuple[int, int]:
        """Record one traffic flow; returns the (raw, compressed) ints it
        booked, so call sites that need the numbers (e.g. checkpoint
        manifests) read them back from the ledger rather than re-deriving
        them."""
        e = event_id(event)
        raw_i = int(raw)
        comp_i = raw_i if compressed is None else int(compressed)
        key = (consumer or self.consumer, tensor_class, e)
        row = self._rows.get(key)
        if row is None:
            row = self._rows[key] = [0, 0, 0]
        row[0] += raw_i
        row[1] += comp_i
        row[2] += int(count)
        return raw_i, comp_i

    def absorb(self, totals, *, tensor_class: str = "default",
               consumer: str | None = None) -> None:
        """Fold a device accumulator (see `device_totals`) into this ledger."""
        t = (totals.cpu().numpy() if isinstance(totals, torch.Tensor)
             else np.asarray(totals))
        assert t.shape == (N_EVENTS, 3), t.shape
        for e in range(N_EVENTS):
            raw, comp, cnt = (int(t[e, 0]), int(t[e, 1]), int(t[e, 2]))
            if raw or comp or cnt:
                self.record(e, raw=raw, compressed=comp, count=cnt,
                            tensor_class=tensor_class, consumer=consumer)

    def merge(self, other: "Ledger") -> "Ledger":
        """Add every row of `other` into this ledger (consumers kept)."""
        for (cons, tc, e), (raw, comp, cnt) in other._rows.items():
            self.record(e, raw=raw, compressed=comp, count=cnt,
                        tensor_class=tc, consumer=cons)
        return self

    # -------------------------------------------------------------- queries
    def _select(self, event=None, consumer=None, tensor_class=None):
        e = None if event is None else event_id(event)
        for (cons, tc, ev), row in self._rows.items():
            if e is not None and ev != e:
                continue
            if consumer is not None and cons != consumer:
                continue
            if tensor_class is not None and tc != tensor_class:
                continue
            yield (cons, tc, ev), row

    def total(self, event=None, *, consumer=None,
              tensor_class=None) -> dict:
        raw = comp = cnt = 0
        for _, (r, c, n) in self._select(event, consumer, tensor_class):
            raw += r
            comp += c
            cnt += n
        return {"raw_bytes": raw, "compressed_bytes": comp, "count": cnt}

    def raw_bytes(self, event=None, **kw) -> int:
        return self.total(event, **kw)["raw_bytes"]

    def compressed_bytes(self, event=None, **kw) -> int:
        return self.total(event, **kw)["compressed_bytes"]

    def saving(self, event=None, **kw) -> float:
        """1 - compressed/raw over the selected rows (the paper's bandwidth
        win; negative when compression *cost* bytes — the §VI signal)."""
        t = self.total(event, **kw)
        return 1.0 - t["compressed_bytes"] / max(t["raw_bytes"], 1)

    def consumers(self) -> tuple[str, ...]:
        return tuple(sorted({c for c, _, _ in self._rows}))

    def tensor_classes(self, consumer=None) -> tuple[str, ...]:
        return tuple(sorted({tc for c, tc, _ in self._rows
                             if consumer is None or c == consumer}))

    def as_dict(self) -> dict:
        """{consumer: {tensor_class: {event: {raw, compressed, count}}}} —
        the JSON view benchmark reports embed."""
        out: dict = {}
        for (cons, tc, e), (raw, comp, cnt) in sorted(self._rows.items()):
            out.setdefault(cons, {}).setdefault(tc, {})[EVENT_NAMES[e]] = {
                "raw_bytes": raw, "compressed_bytes": comp, "count": cnt,
            }
        return out

    def __len__(self) -> int:
        return len(self._rows)

    def __repr__(self) -> str:
        t = self.total()
        return (f"Ledger({self.consumer!r}, rows={len(self._rows)}, "
                f"raw={t['raw_bytes']}, compressed={t['compressed_bytes']})")


# --------------------------------------------------------- device accumulator

def device_totals(device="cuda") -> torch.Tensor:
    """A fresh (N_EVENTS, 3) int64 zero accumulator of [raw_bytes,
    compressed_bytes, count] on `device` (the reference's is int32: one
    serve step of 32 long sessions reads more than 2^31 bytes)."""
    return torch.zeros((N_EVENTS, 3), dtype=torch.int64, device=device)


def device_record(totals, event, raw, compressed=None, count=1):
    """Add one flow to a device accumulator IN PLACE and return it (the
    reference updates functionally and donates the old buffer).  raw /
    compressed / count may be Python ints or 0-d tensors."""
    e = event_id(event)
    comp = raw if compressed is None else compressed

    def cell(x):    # a Python int is filled on the device, not copied
        if torch.is_tensor(x):
            return x.to(totals.device, torch.int64).reshape(())
        return torch.full((), x, dtype=torch.int64, device=totals.device)

    delta = torch.stack([cell(x) for x in (raw, comp, count)])
    totals[e] += delta
    return totals


__all__ = [
    "EV_READ", "EV_WRITE", "EV_PROBE", "EV_REPACK", "EV_SPILL", "N_EVENTS",
    "EVENT_NAMES", "event_id", "Ledger", "device_totals", "device_record",
]
