"""SpillStore: the compressed host-memory tier for cold sequences (port of
`repro.serving.spill`).

Evicting a cold sequence does not decompress its KV: the store re-encodes
the slot's logical pages under the spill tier's own packing (off / pair /
quad, an `AutoTuner` axis of its own) and keeps

  * one packed slot per fitting group, plus its base row — the fit sees
    only the complete live pages (dead lanes and the partially filled last
    page ride as base replicas; the partial page crosses raw in `tail`),
  * the live raw lanes of unfitting groups,
  * the slot's hot-tier bookkeeping: §VI counter, LLP predictor row,
    uncounted-fitness mask, the gate its layout was settled under and the
    hot packing it was evicted from.

Restore is the inverse: decode the payload to logical pages (the page
codecs are exact whenever the fit bit was set), write them into a free
slot with the saved gate state, mark the slot dirty and repack under the
payload's recorded gate.  The incremental layout equals a from-scratch
rebuild, so the woken slot's physical state, and every later attend, is
bit-identical to the never-spilled run.  A sequence waking into a
half-migrated cache joins the pending set under its recorded gate; if the
hot cache switched packing while it was cold, its geometry-indexed
bookkeeping is reset and it lays under the current target.

The encode and decode run on the host with `compression.pagepack` on CPU
tensors.  With `async_spill=True` the evict is split in three:
`_capture` settles the slot and copies its pages to the host on the main
thread (the slot frees at once), `_encode` re-encodes on one FIFO
background worker, and `_commit` books the store insert back on the main
thread when the payload is collected.  `prefetch` queues a payload's
decode behind the in-flight encodes, so `restore` finds the pages ready.
Every evict and every restore books exactly one ledger `spill` row
(`bandwidth.adapters.kv_spill_event`), on the main thread, in submission
order.  The worker never touches the card.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .. import obs
from ..bandwidth import Ledger
from ..bandwidth.adapters import kv_spill_event
from ..compression import pagepack
from .slots import SlotKVCache

SPILL_LANES = {"off": 1, "pair": 2, "quad": 4}


@dataclass
class SpilledSeq:
    """One evicted sequence's payload, still compressed (CPU tensors)."""

    seq_id: int
    tokens: int
    packing: str                 # spill-tier packing the payload uses
    fit: torch.Tensor            # (Gs,) bool — which spill groups packed
    slots: torch.Tensor          # (Gs, page, Hkv, D2) packed slot / lane 0
    bases: torch.Tensor          # (n_fit, Hkv, D2) base rows of fit groups
    overflow: list               # per raw group: (live-1, page, Hkv, D2)
                                 # live raw lanes
    tail: "torch.Tensor | None"  # the partially filled last page, raw —
                                 # only when its group packed without it
    counter: int                 # hot-tier §VI counter at evict
    predictor: torch.Tensor      # (Gh,) hot-tier LLP predictor row
    uncounted: np.ndarray        # (Gh,) hot-tier uncounted-fitness mask
    raw_bytes: int               # decompressed-page cost of this evict
    stored_bytes: int            # payload bytes that actually moved
    gate: bool = True            # gate the hot layout was settled under
    hot_packing: str = "pair"    # hot-tier geometry at evict

    @property
    def n_groups(self) -> int:
        return int(self.fit.numel())


def _payload_bytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that shares no storage with `t` (synchronous from the
    card: the caller overwrites the source right after)."""
    return t.to("cpu", copy=True)


class SpillStore:
    """Host-memory spill tier keyed by sequence id.

    `capacity_pages` bounds the tier (None = unbounded); `packing` is the
    spill-tier layout, independent of the hot cache's.  `async_spill=True`
    moves the re-encode off the decode path; the observable store state is
    the same either way: `__contains__`, `__len__` and the capacity check
    count in-flight evictions, and every read of a payload collects it
    first."""

    def __init__(self, *, packing: str = "quad",
                 capacity_pages: int | None = None,
                 ledger: Ledger | None = None,
                 async_spill: bool = False):
        assert packing in SPILL_LANES, packing
        self.packing = packing
        self.lanes = SPILL_LANES[packing]
        self.capacity_pages = capacity_pages
        self.ledger = ledger if ledger is not None else Ledger("spill")
        self.async_spill = async_spill
        self._store: dict[int, SpilledSeq] = {}
        self._inflight: dict[int, Future] = {}   # seq_id -> encode future
        self._inflight_pages: dict[int, int] = {}
        self._prefetched: dict[int, Future] = {}  # seq_id -> decode future
        self._pool: ThreadPoolExecutor | None = None
        self.spills = 0
        self.restores = 0
        self.raw_bytes = 0        # cumulative decompressed-page duals
        self.stored_bytes = 0     # cumulative payload bytes moved out

    def _worker(self) -> ThreadPoolExecutor:
        # one worker, FIFO: jobs complete in submission order, so a
        # prefetch queued after its sequence's encode can wait on it
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="kv-spill")
        return self._pool

    def __contains__(self, seq_id) -> bool:
        return seq_id in self._store or seq_id in self._inflight

    def __len__(self) -> int:
        return len(self._store) + len(self._inflight)

    def _check_capacity(self, n_pages: int) -> None:
        if (self.capacity_pages is not None
                and self._pages_stored() + n_pages > self.capacity_pages):
            raise RuntimeError(
                f"spill store full ({self._pages_stored()}+{n_pages} pages "
                f"> capacity {self.capacity_pages})")

    def _submit(self, cap: dict) -> None:
        """Encode a captured payload: inline and booked at once in sync
        mode, on the worker and booked at collection in async mode."""
        if not self.async_spill:
            self._commit(self._encode(cap))
            return
        self._inflight_pages[cap["seq_id"]] = cap["n_pages"]
        self._inflight[cap["seq_id"]] = self._worker().submit(
            obs.bind(self._encode), cap)

    # ------------------------------------------------------------- evict
    def evict(self, cache: SlotKVCache, slot: int, seq_id: int) -> None:
        """Move one slot out of the hot cache, still compressed; the slot
        is reset for reuse before this returns."""
        assert seq_id not in self, f"seq {seq_id} already spilled"
        self._submit(self._capture(cache, slot, seq_id))

    def spill_in(self, cache: SlotKVCache, seq_id: int, k, v) -> None:
        """Encode a prompt k/v (T, n_kv, d) straight into the spill tier,
        with no hot lane: the spill-direct half of `ServeLoop.admit`.  The
        payload records the bookkeeping a fresh hot-lane prefill starts
        from (counter at the init, every group uncounted, the default
        target gate), so a later restore + repack gives the physical
        state, attend output and §VI counter of a hot-lane prefill; only
        the LLP predictor row starts unseeded."""
        assert seq_id not in self, f"seq {seq_id} already spilled"

        def bits(x):
            return (torch.as_tensor(x).to("cpu", torch.bfloat16)
                    .view(torch.int16))
        kk, vv = bits(k), bits(v)
        assert kk.dim() == 3, "spill_in takes one sequence (T, n_kv, d)"
        kv = torch.cat([kk, vv], dim=-1)
        tokens = kv.shape[0]
        assert tokens > 0, "spill_in needs a non-empty prompt"
        page = cache.page
        n_pages = -(-tokens // page)
        gs = -(-n_pages // self.lanes)
        self._check_capacity(n_pages)
        pages = torch.zeros((gs * self.lanes, page, cache.n_kv, cache.d2),
                            dtype=torch.int16)
        pages.view(-1, cache.n_kv, cache.d2)[:tokens] = kv
        gh = -(-n_pages // cache.group_lanes)
        self._submit({
            "seq_id": seq_id, "tokens": tokens, "n_pages": n_pages,
            "gs": gs, "pages": pages,
            "counter": cache._counter_init,
            "predictor": torch.zeros(gh, dtype=torch.bool),
            "uncounted": np.ones(gh, bool),
            "gate": cache.default_slot_gate(),
            "hot_packing": cache.packing,
            "raw_bytes": n_pages * cache.slot_bytes,
        })

    def _capture(self, cache: SlotKVCache, slot: int, seq_id: int) -> dict:
        """Main-thread half of an evict: settle the slot's layout (drain
        its pending migration under the frozen target, repack), copy what
        the encode needs to the host, and reset the slot."""
        cache.drain_migration(slot)
        cache.repack(gate=cache._gate_b)   # settle appends, frozen target
        tokens = int(cache.tokens_b[slot])
        assert tokens > 0, "evicting an empty slot"
        page = cache.page
        n_pages = -(-tokens // page)
        gs = -(-n_pages // self.lanes)
        self._check_capacity(n_pages)
        avail = min(gs * self.lanes, cache.max_pages)
        pages = torch.zeros((gs * self.lanes, page, cache.n_kv, cache.d2),
                            dtype=torch.int16)
        gh = cache.slot_groups(slot)
        with obs.d2h(3):
            pages[:avail] = _host(cache.pages_view()[slot, :avail])
            counter = int(cache.state["counter"][slot])
            predictor = _host(cache.state["predictor"][slot, :gh])
        cap = {
            "seq_id": seq_id, "tokens": tokens, "n_pages": n_pages,
            "gs": gs, "pages": pages,
            "counter": counter,
            "predictor": predictor,
            "uncounted": cache._uncounted_b[slot, :gh].copy(),
            "gate": bool(cache._gate_b[slot]),
            "hot_packing": cache.packing,
            "raw_bytes": n_pages * cache.slot_bytes,
        }
        cache.reset_slot(slot)
        return cap

    @obs.span("spill.encode")
    def _encode(self, cap: dict) -> SpilledSeq:
        """Re-encode a captured slot under the spill packing: CPU tensors
        only, safe on the background worker.  All groups pack in one
        call of the page codec (its leading axes broadcast)."""
        tokens, pages, gs = cap["tokens"], cap["pages"], cap["gs"]
        page, hkv, d2 = pages.shape[1:]
        lanes = self.lanes
        bases = torch.empty((0, hkv, d2), dtype=torch.int16)
        overflow, tail = [], None
        if self.packing == "off":
            fit = torch.zeros(gs, dtype=torch.bool)
            slots = pages.clone()                 # lanes == 1: page == group
        else:
            grp = pages.view(gs, lanes, page, hkv, d2)
            n_full, rem = divmod(tokens, page)
            first = torch.arange(gs) * lanes
            full = (n_full - first).clamp(0, lanes)
            partial = (rem > 0) & (full < lanes) & (first + full == n_full)
            live = full + partial.long()
            # the fit sees only the complete live pages: dead lanes and
            # the partial page ride as base-page replicas (delta 0); the
            # partial page crosses raw in `tail` and restore re-zeroes the
            # dead lanes.  Fewer than 2 complete pages never pack.
            dead = torch.arange(lanes)[None, :] >= full[:, None]
            src = torch.where(dead[:, :, None, None, None], grp[:, :1], grp)
            pack = (pagepack.pack_pair if self.packing == "pair"
                    else pagepack.pack_quad)
            ok, packed, base = pack(*src.unbind(1))
            fit = ok & (full >= 2)
            slots = torch.where(fit[:, None, None, None], packed, grp[:, 0])
            bases = base[fit].clone()
            for g in torch.nonzero(~fit).flatten().tolist():
                # raw group: lane 0 in the slot row, live extra lanes in
                # overflow — dead lanes never cross the link
                overflow.append(grp[g, 1:int(live[g])].clone())
            last = torch.nonzero(fit & partial).flatten().tolist()
            if last:
                tail = grp[last[0], int(full[last[0]])].clone()
        return SpilledSeq(
            seq_id=cap["seq_id"], tokens=tokens, packing=self.packing,
            fit=fit, slots=slots, bases=bases, overflow=overflow, tail=tail,
            counter=cap["counter"], predictor=cap["predictor"],
            uncounted=cap["uncounted"], raw_bytes=cap["raw_bytes"],
            stored_bytes=_payload_bytes(
                slots, bases, fit, *overflow,
                *(() if tail is None else (tail,))),
            gate=cap["gate"], hot_packing=cap["hot_packing"],
        )

    def _commit(self, payload: SpilledSeq) -> None:
        """Book one completed evict: store insert, byte totals and the
        single ledger `spill` row.  Runs on the main thread."""
        self._store[payload.seq_id] = payload
        self.spills += 1
        self.raw_bytes += payload.raw_bytes
        self.stored_bytes += payload.stored_bytes
        kv_spill_event(self.ledger, raw=payload.raw_bytes,
                       compressed=payload.stored_bytes, direction="evict")

    def _collect(self, seq_id) -> None:
        """Join one in-flight evict and commit it (main thread).  Commit
        before dropping the in-flight entry, so a worker-side `_payload`
        lookup always finds the sequence in one map or the other."""
        fut = self._inflight.get(seq_id)
        if fut is not None:
            self._commit(fut.result())
            del self._inflight[seq_id]
            self._inflight_pages.pop(seq_id, None)

    def flush(self) -> int:
        """Join every in-flight evict, committing in submission order;
        returns the number collected."""
        pending = list(self._inflight)
        for sid in pending:
            self._collect(sid)
        return len(pending)

    # ----------------------------------------------------------- prefetch
    def _payload(self, seq_id) -> SpilledSeq:
        # one FIFO worker: an encode submitted before this job has
        # finished, so .result() cannot wait on the worker itself
        p = self._store.get(seq_id)
        if p is not None:
            return p
        fut = self._inflight.get(seq_id)
        if fut is not None:
            return fut.result()
        return self._store[seq_id]

    @obs.span("spill.decode")
    def _decode_pages(self, p: SpilledSeq, page: int) -> torch.Tensor:
        """Payload -> logical pages (n_groups*lanes, page, Hkv, D2) on the
        host: the pure half of a restore, runnable on the worker."""
        hkv, d2 = p.slots.shape[-2:]
        # decode under the packing the payload was evicted with, not the
        # store's current one (per-tier retuning may change it)
        lanes = SPILL_LANES[p.packing]
        pages = torch.zeros((p.n_groups * lanes, page, hkv, d2),
                            dtype=torch.int16)
        if p.packing == "off":
            pages[:] = p.slots
        else:
            grp = pages.view(p.n_groups, lanes, page, hkv, d2)
            fit_idx = torch.nonzero(p.fit).flatten()
            if fit_idx.numel():
                unpack = (pagepack.unpack_pair if p.packing == "pair"
                          else pagepack.unpack_quad)
                grp[fit_idx] = torch.stack(
                    unpack(p.slots[fit_idx], p.bases), 1)
            raw_idx = torch.nonzero(~p.fit).flatten().tolist()
            for g, ov in zip(raw_idx, p.overflow, strict=True):
                grp[g, 0] = p.slots[g]
                grp[g, 1:1 + len(ov)] = ov
        if p.tail is not None:             # partial page shipped raw beside
            pages[p.tokens // page] = p.tail        # its packed group
        pages[-(-p.tokens // page):] = 0   # dead lanes back to zeros
        return pages

    def prefetch(self, seq_id, page: int) -> bool:
        """Start decoding a spilled payload on the worker so a later
        `restore` finds the pages expanded; queued behind any in-flight
        encode of the same sequence.  False for unknown or already
        prefetched sequences, and in sync mode."""
        if seq_id not in self or seq_id in self._prefetched:
            return False
        if not self.async_spill:
            return False
        fut = self._worker().submit(obs.bind(
            lambda: self._decode_pages(self._payload(seq_id), page)))
        self._prefetched[seq_id] = fut
        return True

    # ------------------------------------------------------------ restore
    def restore(self, cache: SlotKVCache, slot: int, seq_id: int) -> None:
        """Wake one sequence into a free slot: decode the payload (or take
        the prefetched pages), write the pages to the cache's device in
        place, reinstall the gate state and repack under the payload's
        recorded gate.  Books one ledger `spill` row."""
        self._collect(seq_id)              # join an in-flight encode first
        assert int(cache.tokens_b[slot]) == 0, "restore needs a free slot"
        page = cache.page
        # resolve the prefetch before popping the payload: the queued
        # decode reads the store entry
        pre = self._prefetched.pop(seq_id, None)
        pages = pre.result() if pre is not None else None
        p = self._store.pop(seq_id)
        if pages is None:
            pages = self._decode_pages(p, page)
        hkv, d2 = p.slots.shape[-2:]
        n_rows = min(pages.shape[0], cache.max_pages) * page
        flat = pages.view(-1, hkv, d2)[:n_rows]
        st = cache.state
        st["pages"][slot, :n_rows] = flat.to(cache.device)
        st["counter"][slot] = p.counter
        cache.tokens_b[slot] = p.tokens
        cache.tokens = int(cache.tokens_b.max())
        gh = cache.slot_groups(slot)
        gate_vec = cache._gate_b.copy()
        if p.hot_packing == cache.packing:
            # same geometry: the hot bookkeeping slots back in and the
            # layout resurrects under the gate it was settled with
            assert gh == p.predictor.numel(), (gh, p.predictor.numel())
            st["predictor"][slot, :gh] = p.predictor.to(cache.device)
            cache._uncounted_b[slot, :gh] = p.uncounted
            gate_vec[slot] = p.gate
        else:
            # the hot cache switched packing while the sequence was cold:
            # predictor/uncounted are indexed in the old geometry — reset
            # (history is not re-counted) and lay under the current target
            cache._uncounted_b[slot, :gh] = False
        cache._dirty_b[slot, :gh] = True
        self.restores += 1
        kv_spill_event(self.ledger, raw=p.raw_bytes,
                       compressed=p.stored_bytes, direction="restore")
        cache.repack(gate=gate_vec)   # materialise the resurrected layout

    def drop(self, seq_id) -> None:
        """Discard a spilled sequence (retired while cold).  An in-flight
        evict is collected first: its crossing happened and books once."""
        self._collect(seq_id)
        pre = self._prefetched.pop(seq_id, None)
        if pre is not None:
            pre.result()   # let a queued decode finish reading the entry
        self._store.pop(seq_id)

    # ------------------------------------------------------------ queries
    def _pages_stored(self) -> int:
        return (sum(p.n_groups * SPILL_LANES[p.packing]
                    for p in self._store.values())
                + sum(self._inflight_pages.values()))

    def saving(self) -> float:
        """1 - stored/raw over every spill so far (the link-bytes win)."""
        return 1.0 - self.stored_bytes / max(self.raw_bytes, 1)

    def summary(self) -> dict:
        self.flush()
        return {"packing": self.packing, "held": len(self._store),
                "spills": self.spills, "restores": self.restores,
                "raw_bytes": self.raw_bytes,
                "stored_bytes": self.stored_bytes,
                "saving": round(self.saving(), 4)}


__all__ = ["SpillStore", "SpilledSeq", "SPILL_LANES"]
