"""ServeLoop: continuous batching over slot-reused KV lanes and the
compressed spill tier (port of `repro.serving.loop`).

A fixed pool of `slots` batch lanes in one `SlotKVCache`, a
`SequenceSlot` record per live sequence and a `SpillStore` behind them:

  admit   — take the lowest free slot (evicting the coldest active
            sequence when none is free, or encoding the newcomer straight
            into the spill tier when it would itself be the coldest) and
            prefill it;
  step    — one decode append for every sequence named this step;
            spilled ones are woken first, and a wake never evicts a
            sequence the same step names.  The default `fused=True` runs
            `SlotKVCache.megastep`, `fused=False` the append / migration
            quantum / repack / account sequence.  `step_all` runs an
            oversubscribed batch in waves of `slots`, resident sequences
            first, and prefetches the spilled ones' payload decodes;
  attend  — one batched decode-attend over the whole slot axis (inactive
            lanes are masked by their zero valid counts);
  retire  — reset the lane (or drop the spill payload) and hand it to the
            next admit: the batch axis never grows;
  evict / wake — explicit spill-tier crossings, each booking exactly one
            ledger `spill` row.  With the default `async_spill=True` the
            evict's re-encode runs on a background worker and books at
            collection (`sync_ledger` flushes).

Per-tier autotuning: `ServeLoop.auto` asks one `AutoTuner` for the hot
packing (decode model, gate key "kv-hot") and the spill packing
(spill-link model, gate key "kv-spill") from the same KV sample, and
`observe_tiers()` feeds each tier's §VI counter from its own ledger rows.
A window that re-enables a hot gate which had suppressed the tuner's pick
migrates the live cache to that pick; a window that turns it off degrades
the layout to raw, incrementally.
"""

from __future__ import annotations

from bisect import insort
from dataclasses import dataclass, field

import torch

from .. import obs
from ..bandwidth import AutoTuner, Ledger
from ..compression.framing import DEFAULT_MARKER_KEY
from ..compression.gate import COUNTER_INIT
from ..kernels.ref import MARKER_LANES
from ..kv.cache import to_device
from .shard import shard_kv_attend
from .slots import SlotKVCache
from .spill import SpillStore


@dataclass
class SequenceSlot:
    """One live sequence's scheduling record."""

    seq_id: int
    slot: int                  # batch-lane index; -1 while spilled
    admitted_at: int
    last_step: int
    spilled: bool = False
    meta: dict = field(default_factory=dict)


class ServeLoop:
    """Continuous-batching serve tier over one SlotKVCache + SpillStore."""

    def __init__(self, *, slots: int, max_pages: int, page: int, n_kv: int,
                 head_dim: int, policy: str = "dynamic",
                 packing: str = "pair", spill_packing: str = "quad",
                 spill_pages: int | None = None,
                 tuner: AutoTuner | None = None,
                 ledger: Ledger | None = None, key: int = DEFAULT_MARKER_KEY,
                 counter_init: int = COUNTER_INIT, fused: bool = True,
                 migrate_budget: int = 1, async_spill: bool = True,
                 device="cuda"):
        self.ledger = ledger if ledger is not None else Ledger("serve")
        self.cache = SlotKVCache(max_pages, page, n_kv, head_dim,
                                 batch=slots, policy=policy, packing=packing,
                                 key=key, counter_init=counter_init,
                                 ledger=self.ledger, device=device)
        self.spill = SpillStore(packing=spill_packing,
                                capacity_pages=spill_pages,
                                ledger=self.ledger, async_spill=async_spill)
        self.tuner = tuner
        self.n_slots = slots
        self.fused = fused
        self.migrate_budget = migrate_budget
        self._free = list(range(slots))       # kept sorted: lowest first
        self.seqs: dict[int, SequenceSlot] = {}
        self.clock = 0
        self.counts = {"admitted": 0, "retired": 0, "evicted": 0,
                       "woken": 0, "spilled_direct": 0}
        self.choices: dict = {}
        # the tuner's hot pick while the gate suppressed it to "off": a
        # live re-enable migrates to this, not to a default
        self.suppressed_packing: str | None = None
        self._gate_seen: dict[str, bool] = {}

    @classmethod
    def auto(cls, tuner: AutoTuner, k_sample, v_sample, *, slots: int,
             max_pages: int, page: int, n_kv: int, head_dim: int, **kw):
        """`--kv-policy auto`: per-tier packing from one KV sample, hot
        under the decode model and spill under the spill-link model, each
        with its own gate key.  Returns (loop, {"hot": .., "spill": ..}).
        A gate-suppressed hot pick is recorded (`suppressed_packing`)."""
        d2 = 2 * head_dim
        slot_bytes = page * n_kv * d2 * 2
        strip_bytes = n_kv * (d2 + MARKER_LANES) * 2
        hot = tuner.choose_kv_packing(
            k=k_sample, v=v_sample, page=page, slot_bytes=slot_bytes,
            strip_bytes=strip_bytes, tier="hot", gate_key="kv-hot")
        spl = tuner.choose_kv_packing(
            k=k_sample, v=v_sample, page=page, slot_bytes=slot_bytes,
            tier="spill")   # the spill-link model has no strip term
        policy, packing = (("off", "pair") if hot.choice == "off"
                           else ("auto", hot.choice))
        loop = cls(slots=slots, max_pages=max_pages, page=page, n_kv=n_kv,
                   head_dim=head_dim, policy=policy, packing=packing,
                   spill_packing=spl.choice, tuner=tuner, **kw)
        loop.choices = {"hot": hot, "spill": spl}
        if hot.choice == "off" and hot.preferred not in ("", "off"):
            loop.suppressed_packing = hot.preferred
        loop._gate_seen["kv-hot"] = tuner.gate_enabled("kv-hot")
        return loop, loop.choices

    # --------------------------------------------------------- scheduling
    def _coldest_active(self, protect: frozenset = frozenset()
                        ) -> SequenceSlot:
        cands = [s for s in self.seqs.values()
                 if not s.spilled and s.seq_id not in protect]
        assert cands, "no evictable active sequence"
        return min(cands, key=lambda s: (s.last_step, s.admitted_at,
                                         s.seq_id))

    def _take_slot(self, protect: frozenset = frozenset()) -> int:
        if not self._free:
            self.evict(protect=protect)
        return self._free.pop(0)

    def _incoming_is_coldest(self, seq_id) -> bool:
        """Would an incoming sequence, whose record sorts at (last_step =
        clock, admitted_at = clock, seq_id), itself be the next eviction
        victim?"""
        cold = self._coldest_active()
        return ((self.clock, self.clock, seq_id)
                < (cold.last_step, cold.admitted_at, cold.seq_id))

    @obs.span("serve.admit")
    def admit(self, seq_id, k=None, v=None, *, prompt=None) -> SequenceSlot:
        """Join a sequence mid-flight: k/v (T, n_kv, d) prefill its slot
        through the incremental append; `prompt=(k, v)` takes the fused
        chunked-prefill path (`SlotKVCache.prefill_slot`).  With no free
        slot the coldest active sequence is evicted, unless the incoming
        one would itself be the coldest: then its prompt is encoded
        straight into the spill tier (`SpillStore.spill_in`)."""
        assert seq_id not in self.seqs, f"seq {seq_id} already live"
        if prompt is not None:
            assert k is None and v is None, "pass k/v or prompt=, not both"
            k, v = prompt
        if (k is not None and not self._free
                and self._incoming_is_coldest(seq_id)):
            rec = SequenceSlot(seq_id, -1, self.clock, self.clock,
                               spilled=True)
            self.seqs[seq_id] = rec
            self.spill.spill_in(self.cache, seq_id, k, v)
            self.counts["admitted"] += 1
            self.counts["spilled_direct"] += 1
            return rec
        slot = self._take_slot()
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
        """Admit with the fused chunked-prefill ingest of k/v (T, n_kv, d),
        or straight into the spill tier (see `admit`)."""
        return self.admit(seq_id, prompt=(k, v))

    @obs.span("serve.retire")
    def retire(self, seq_id) -> None:
        """Finish a sequence: its lane resets and returns to the free pool,
        or its spill payload is dropped."""
        rec = self.seqs.pop(seq_id)
        if rec.spilled:
            self.spill.drop(seq_id)
        else:
            self.cache.reset_slot(rec.slot)
            insort(self._free, rec.slot)
        self.counts["retired"] += 1

    @obs.span("serve.evict")
    def evict(self, seq_id=None, *,
              protect: frozenset = frozenset()) -> SequenceSlot:
        """Spill one active sequence compressed: `seq_id`, or the coldest
        active one outside `protect`.  The slot frees at once."""
        rec = self.seqs[seq_id] if seq_id is not None else (
            self._coldest_active(protect))
        self.spill.evict(self.cache, rec.slot, rec.seq_id)  # resets slot
        insort(self._free, rec.slot)
        rec.slot, rec.spilled = -1, True
        self.counts["evicted"] += 1
        return rec

    @obs.span("serve.wake")
    def wake(self, seq_id, *,
             protect: frozenset = frozenset()) -> SequenceSlot:
        """Restore a spilled sequence into a free slot, evicting the
        coldest active one outside `protect` if none is free."""
        rec = self.seqs[seq_id]
        if not rec.spilled:
            return rec
        slot = self._take_slot(protect)
        self.spill.restore(self.cache, slot, seq_id)
        rec.slot, rec.spilled = slot, False
        rec.last_step = self.clock
        self.counts["woken"] += 1
        return rec

    # ------------------------------------------------------------ serving
    @obs.span("serve.step")
    def step(self, kv_by_seq: dict) -> dict:
        """One decode step: `{seq_id: (k, v)}` with k/v (T, n_kv, d), all
        the same T.  Spilled sequences named here are woken first, and
        those wakes never evict a sequence this step names.  The batch is
        stacked on the cache's device; the fused path runs append + repack
        + migration quantum + booking as one `megastep`.  Returns
        {seq_id: slot}."""
        self.clock += 1
        ids = sorted(kv_by_seq)
        if len(ids) > self.n_slots:
            raise ValueError(
                f"step names {len(ids)} sequences but the pool has only "
                f"{self.n_slots} slots; use step_all() to run in waves")
        named = frozenset(ids)
        for sid in ids:
            if self.seqs[sid].spilled:
                self.wake(sid, protect=named)
        slot_ids = []
        for sid in ids:
            rec = self.seqs[sid]
            assert not rec.spilled and rec.slot >= 0, (sid, rec)
            slot_ids.append(rec.slot)
        dev = self.cache.device
        k = torch.stack([to_device(kv_by_seq[sid][0], dev) for sid in ids])
        v = torch.stack([to_device(kv_by_seq[sid][1], dev) for sid in ids])
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
        """`step` in waves of at most `n_slots` sequences: resident ones
        first, then spilled ones, whose wakes may evict earlier waves'
        members (appended by then).  The spilled members' payload decodes
        are prefetched onto the spill worker up front.  Returns the merged
        {seq_id: slot}, each slot from its sequence's own wave."""
        ids = sorted(kv_by_seq)
        order = ([s for s in ids if not self.seqs[s].spilled]
                 + [s for s in ids if self.seqs[s].spilled])
        for sid in order:
            if self.seqs[sid].spilled:
                self.spill.prefetch(sid, self.cache.page)
        out: dict = {}
        for i in range(0, len(order), self.n_slots):
            wave = order[i:i + self.n_slots]
            out.update(self.step({s: kv_by_seq[s] for s in wave}))
        return out

    @obs.span("serve.attend")
    def attend(self, q_by_seq: dict, *, shard: "bool | str" = "auto") -> dict:
        """Batched decode-attend for `{seq_id: q}` with q (Hq, d): one kernel
        launch over the whole slot axis (one a shard where `shard`, passed
        on to `shard_kv_attend`, shards it), inactive lanes masked by
        valid.  Returns {seq_id: (Hq, d)}."""
        ids = sorted(q_by_seq)
        for sid in ids:
            assert not self.seqs[sid].spilled, f"seq {sid} is spilled"
        dev = self.cache.device
        rows = {sid: to_device(q_by_seq[sid], dev, torch.float32)
                for sid in ids}
        q = torch.zeros((self.n_slots,) + tuple(rows[ids[0]].shape),
                        dtype=torch.float32, device=dev)
        for sid in ids:
            q[self.seqs[sid].slot] = rows[sid]
        out = shard_kv_attend(self.cache, q, shard=shard)
        return {sid: out[self.seqs[sid].slot] for sid in ids}

    # ------------------------------------------------------------- policy
    def sync_ledger(self) -> None:
        """Collect the in-flight evictions (their spill rows book first),
        then fold the cache's device traffic window into the host
        ledger."""
        self.spill.flush()
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
        """One §VI observation window per tier: hot judged on the decode
        "read" rows, spill on the "spill" rows.  The hot gate decision is
        applied live: a window that re-enables a gate which had suppressed
        the tuner's pick migrates the cache to that pick; a window that
        turns it off re-targets the layout to raw."""
        if self.tuner is None:
            return {}
        self.sync_ledger()
        out = {
            "kv-hot": self.tuner.observe(self.ledger, key="kv-hot",
                                         consumer="kv", event="read"),
            "kv-spill": self.tuner.observe(self.ledger, key="kv-spill",
                                           consumer="kv", event="spill"),
        }
        hot_on = self.tuner.gate_enabled("kv-hot")
        prev = self._gate_seen.get("kv-hot")
        if prev is not None and hot_on != prev:
            if hot_on and self.suppressed_packing:
                self.migrate_to(policy="auto",
                                packing=self.suppressed_packing)
                self.suppressed_packing = None
            elif not hot_on and self.cache.policy != "off":
                self.suppressed_packing = self.cache.packing
                self.migrate_to(policy="off")
        self._gate_seen["kv-hot"] = hot_on
        return out

    # ------------------------------------------------------------ queries
    def active_seqs(self) -> list:
        return sorted(s for s, r in self.seqs.items() if not r.spilled)

    def spilled_seqs(self) -> list:
        return sorted(s for s, r in self.seqs.items() if r.spilled)

    def summary(self) -> dict:
        self.sync_ledger()
        return {
            "slots": self.n_slots, "clock": self.clock,
            "live": len(self.seqs), "active": len(self.active_seqs()),
            "spilled": len(self.spilled_seqs()),
            **self.counts,
            "spill_tier": self.spill.summary(),
            "hot_packing": (self.cache.packing
                            if self.cache.policy != "off" else "off"),
            "suppressed_packing": self.suppressed_packing,
            "migration": self.cache.migration_status(),
            "decode_saving": round(self.ledger.saving(
                "read", consumer="kv"), 4),
        }


__all__ = ["ServeLoop", "SequenceSlot"]
