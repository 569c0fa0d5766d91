"""ServeLoop: continuous batching over slot-reused KV lanes (port of
`repro.serving.loop`, without the spill tier).

A fixed pool of `slots` batch lanes in one `SlotKVCache` and a
`SequenceSlot` record per live sequence:

  admit   — take the lowest free slot and prefill it;
  step    — one decode append for every sequence named this step; the
            default `fused=True` runs `SlotKVCache.megastep`, `fused=False`
            the append / migration quantum / repack / account sequence;
            `step_all` runs an oversubscribed batch in waves of `slots`;
  attend  — one batched decode-attend over the whole slot axis (inactive
            lanes are masked by their zero valid counts);
  retire  — reset the lane and hand it to the next admit: the batch axis
            never grows.

The spill tier (`evict`, `wake`, spill-direct admit) and the AutoTuner
(`ServeLoop.auto`, `observe_tiers` windows) come with the next slice and
raise `NotImplementedError` here; `summary()` keeps the reference's keys
with `spill_tier: None`.
"""

from __future__ import annotations

from bisect import insort
from dataclasses import dataclass

import torch

from ..bandwidth import Ledger
from ..compression.framing import DEFAULT_MARKER_KEY
from ..compression.gate import COUNTER_INIT
from .shard import shard_kv_attend
from .slots import SlotKVCache

_NEXT_SLICE = "spill tier / AutoTuner: port slice 2"


@dataclass
class SequenceSlot:
    """One live sequence's scheduling record."""

    seq_id: int
    slot: int                  # batch-lane index
    admitted_at: int
    last_step: int


class ServeLoop:
    """Continuous-batching serve tier over one SlotKVCache."""

    def __init__(self, *, slots: int, max_pages: int, page: int, n_kv: int,
                 head_dim: int, policy: str = "dynamic",
                 packing: str = "pair", ledger: Ledger | None = None,
                 key: int = DEFAULT_MARKER_KEY,
                 counter_init: int = COUNTER_INIT, fused: bool = True,
                 migrate_budget: int = 1, device="cuda"):
        self.ledger = ledger if ledger is not None else Ledger("serve")
        self.cache = SlotKVCache(max_pages, page, n_kv, head_dim,
                                 batch=slots, policy=policy, packing=packing,
                                 key=key, counter_init=counter_init,
                                 ledger=self.ledger, device=device)
        self.n_slots = slots
        self.fused = fused
        self.migrate_budget = migrate_budget
        self._free = list(range(slots))       # kept sorted: lowest first
        self.seqs: dict[int, SequenceSlot] = {}
        self.clock = 0
        self.counts = {"admitted": 0, "retired": 0, "evicted": 0,
                       "woken": 0, "spilled_direct": 0}
        self.suppressed_packing: str | None = None

    @classmethod
    def auto(cls, *args, **kwargs):
        raise NotImplementedError(_NEXT_SLICE)

    # --------------------------------------------------------- scheduling
    def admit(self, seq_id, k=None, v=None, *, prompt=None) -> SequenceSlot:
        """Join a sequence mid-flight: k/v (T, n_kv, d) prefill its slot
        through the incremental append; `prompt=(k, v)` takes the fused
        chunked-prefill path (`SlotKVCache.prefill_slot`)."""
        assert seq_id not in self.seqs, f"seq {seq_id} already live"
        if prompt is not None:
            assert k is None and v is None, "pass k/v or prompt=, not both"
            k, v = prompt
        if not self._free:
            raise NotImplementedError(_NEXT_SLICE)
        slot = self._free.pop(0)
        rec = SequenceSlot(seq_id, slot, self.clock, self.clock)
        self.seqs[seq_id] = rec
        if k is not None:
            if prompt is not None:
                self.cache.prefill_slot(slot, k, v)
            else:
                self.cache.append_slot(slot, k, v)
        self.counts["admitted"] += 1
        return rec

    def prefill(self, seq_id, k, v) -> SequenceSlot:
        """Admit with the fused chunked-prefill ingest of k/v (T, n_kv, d)."""
        return self.admit(seq_id, prompt=(k, v))

    def retire(self, seq_id) -> None:
        """Finish a sequence: its lane resets and returns to the free pool."""
        rec = self.seqs.pop(seq_id)
        self.cache.reset_slot(rec.slot)
        insort(self._free, rec.slot)
        self.counts["retired"] += 1

    def evict(self, *args, **kwargs):
        raise NotImplementedError(_NEXT_SLICE)

    def wake(self, *args, **kwargs):
        raise NotImplementedError(_NEXT_SLICE)

    # ------------------------------------------------------------ serving
    def step(self, kv_by_seq: dict) -> dict:
        """One decode step: `{seq_id: (k, v)}` with k/v (T, n_kv, d), all
        the same T.  The per-step batch is stacked on the cache's device;
        the fused path runs append + repack + migration quantum + booking
        as one `megastep`.  Returns {seq_id: slot}."""
        self.clock += 1
        ids = sorted(kv_by_seq)
        if len(ids) > self.n_slots:
            raise ValueError(
                f"step names {len(ids)} sequences but the pool has only "
                f"{self.n_slots} slots; use step_all() to run in waves")
        slot_ids = [self.seqs[sid].slot for sid in ids]
        dev = self.cache.device
        k = torch.stack([torch.as_tensor(kv_by_seq[sid][0], device=dev)
                         for sid in ids])
        v = torch.stack([torch.as_tensor(kv_by_seq[sid][1], device=dev)
                         for sid in ids])
        if self.fused:
            self.cache.megastep(slot_ids, k, v, budget=self.migrate_budget)
        else:
            self.cache.append_active(slot_ids, k, v)
            self.cache.migration_quantum(self.migrate_budget)
            self.cache.account_step()
        for sid in ids:
            self.seqs[sid].last_step = self.clock
        return dict(zip(ids, slot_ids, strict=True))

    def step_all(self, kv_by_seq: dict) -> dict:
        """`step` in waves of at most `n_slots` sequences."""
        ids = sorted(kv_by_seq)
        out: dict = {}
        for i in range(0, len(ids), self.n_slots):
            wave = ids[i:i + self.n_slots]
            out.update(self.step({s: kv_by_seq[s] for s in wave}))
        return out

    def attend(self, q_by_seq: dict, *, shard: "bool | str" = "auto") -> dict:
        """Batched decode-attend for `{seq_id: q}` with q (Hq, d): one kernel
        launch over the whole slot axis, inactive lanes masked by valid.
        Returns {seq_id: (Hq, d)}."""
        ids = sorted(q_by_seq)
        dev = self.cache.device
        rows = {sid: torch.as_tensor(q_by_seq[sid], dtype=torch.float32,
                                     device=dev) for sid in ids}
        q = torch.zeros((self.n_slots,) + tuple(rows[ids[0]].shape),
                        dtype=torch.float32, device=dev)
        for sid in ids:
            q[self.seqs[sid].slot] = rows[sid]
        out = shard_kv_attend(self.cache, q, shard=shard)
        return {sid: out[self.seqs[sid].slot] for sid in ids}

    # ------------------------------------------------------------- policy
    def sync_ledger(self) -> None:
        """Fold the cache's device traffic window into the host ledger."""
        self.cache.sync_ledger()

    def migrate_to(self, *, packing: str | None = None,
                   policy: str | None = None) -> dict:
        """Re-target the live hot cache (policy and/or packing), then refresh
        the per-slot target gate; the layout converges incrementally."""
        if policy is not None:
            assert policy in ("dynamic", "static", "off", "auto")
            self.cache.policy = policy
        if packing is not None:
            self.cache.switch_packing(packing)
        self.cache.refresh_gate()
        return self.cache.migration_status()

    def observe_tiers(self) -> dict:
        """Per-tier §VI observation windows need the AutoTuner (next
        slice); with no tuner the reference returns {} too."""
        return {}

    # ------------------------------------------------------------ queries
    def active_seqs(self) -> list:
        return sorted(self.seqs)

    def spilled_seqs(self) -> list:
        return []

    def summary(self) -> dict:
        self.sync_ledger()
        return {
            "slots": self.n_slots, "clock": self.clock,
            "live": len(self.seqs), "active": len(self.active_seqs()),
            "spilled": len(self.spilled_seqs()),
            **self.counts,
            "spill_tier": None,
            "hot_packing": (self.cache.packing
                            if self.cache.policy != "off" else "off"),
            "suppressed_packing": self.suppressed_packing,
            "migration": self.cache.migration_status(),
            "decode_saving": round(self.ledger.saving(
                "read", consumer="kv"), 4),
        }


__all__ = ["ServeLoop", "SequenceSlot"]
