"""CRAM-KV: batched paged serving cache with marker-packed page groups
(port of `repro.kv.cache`).

Logical KV pages pack groupwise into physical slots when
delta-compressible; interpretation is by in-band marker (the decode
kernel); a last-compressibility predictor (the LLP analog) indexed by page
group decides whether the overflow slots need fetching; a per-sequence
§VI counter turns packing off when the data never compresses, while still
sampling pack fitness on repacked groups so it can re-enable.

Two layouts: packing="pair" (2 pages per group, int8 deltas) and
packing="quad" (4 pages, int4 deltas, quad-domain markers).

The state is a dict of tensors on the cache's device with a batch axis
(B sequences x page groups).  Where the reference's jitted steps donated
their buffers, the port updates the preallocated state tensors in place.
`repack` is incremental over a dirty-group mask, so a decode step
re-packs O(new groups); the incremental state is bit-identical to a
from-scratch `reference_rebuild` under the gate of the last repack.

Accounting is device-resident: the decode kernel emits the (raw, cram)
bytes of the layout it walked, and every per-step tally lands in int64
accumulators in the state (`traffic` is a `bandwidth.device_totals`
tensor; the reference's are int32, equal below 2^31); `sync_ledger` folds
them into the host `Ledger`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import obs
from ..bandwidth import Ledger
from ..bandwidth.adapters import (kv_read_device, kv_repack_device,
                                  kv_window_fold)
from ..bandwidth.ledger import device_totals
from ..compression.framing import DEFAULT_MARKER_KEY, DOMAIN_PAIR, DOMAIN_QUAD
from ..compression.gate import COUNTER_INIT, COUNTER_MAX, ENABLE_THRESHOLD
from ..compression.predictor import observe_layout
from ..device import resolve_device
from ..kernels import ops as kops
from ..kernels.ref import MARKER_LANES, marker_to_lanes, slot_markers


@dataclass
class KVStats:
    """Pack/predictor event counters (bytes live in the cache's ledger).
    The layout/predictor tallies come from device counters on read; the
    dispatch-shape counters are plain host ints."""

    packed_pairs: int = 0
    raw_pairs: int = 0
    predictor_hits: int = 0
    predictor_misses: int = 0
    pack_attempts: int = 0
    pack_skipped_dynamic: int = 0
    pack_calls: int = 0
    pack_pairs_processed: int = 0  # sequences x groups run through repack


def to_device(x, device, dtype=None) -> torch.Tensor:
    """`x` as a tensor (of `dtype`) on `device`.  A host array (not a
    tensor, or a CPU tensor bound for a card) counts as one `host.h2d`
    crossing."""
    if torch.is_tensor(x) and (not x.is_cpu
                               or torch.device(device).type == "cpu"):
        return torch.as_tensor(x, dtype=dtype, device=device)
    t = torch.as_tensor(x, dtype=dtype)
    with obs.h2d(t.nbytes):
        return t.to(device)


def kv_bits(k, v, device) -> torch.Tensor:
    """k/v (..., n_kv, d) floats -> (..., n_kv, 2d) int16 bf16 bit patterns
    (K || V), converted on `device`."""
    def bits(x):
        return to_device(x, device).to(torch.bfloat16).view(torch.int16)
    return torch.cat([bits(k), bits(v)], dim=-1)


def kernel_cache_slice(state: dict, n: int) -> dict:
    """The decode-kernel view of a cache state restricted to the first `n`
    page groups."""
    return {"slots": state["slots"][:, :n],
            "slots_overflow": state["slots_overflow"][:, :n],
            "strips": state["strips"][:, :n],
            "packed_mask": state["packed_mask"][:, :n],
            "markers": state["markers"][:n]}


def counter_update(counter, fit, countable) -> None:
    """§VI update in place: +1 per countable fitting group, -1 per
    countable unfit group, saturating to [0, COUNTER_MAX]."""
    fit_n = (fit & countable).sum(1)
    unfit_n = ((~fit) & countable).sum(1)
    counter.copy_(torch.clamp(counter + (fit_n - unfit_n).to(torch.int32),
                              0, COUNTER_MAX))


def scatter_window(st: dict, idx, slots_w, over_w, strips_w, lay) -> None:
    """Write a laid window back into the physical state at group columns
    `idx`, in place.  A padded `idx` repeats a column; the repeated writes
    carry identical values."""
    st["slots"][:, idx] = slots_w
    st["slots_overflow"][:, idx] = over_w
    st["strips"][:, idx] = strips_w
    st["packed_mask"][:, idx] = lay


class CRAMKVCache:
    """Batched paged KV cache: B sequences, uniform token counts."""

    def __init__(self, max_pages: int, page: int, n_kv: int, head_dim: int,
                 *, batch: int = 1, policy: str = "dynamic",
                 packing: str = "pair", key: int = DEFAULT_MARKER_KEY,
                 counter_init: int = COUNTER_INIT,
                 ledger: Ledger | None = None, device="cuda"):
        # "auto" is the §VI dynamic gate over a layout an AutoTuner picked
        assert policy in ("dynamic", "static", "off", "auto")
        assert packing in ("pair", "quad")
        self.device = resolve_device(device)
        self.packing = packing
        self.group_lanes = 2 if packing == "pair" else 4
        max_pages = -(-max_pages // self.group_lanes) * self.group_lanes
        self.page, self.n_kv, self.d = page, n_kv, head_dim
        self.d2 = 2 * head_dim
        self.max_pages = max_pages
        self.n_groups = max_pages // self.group_lanes
        self.batch = batch
        self.policy = policy
        self.key = key
        self.tokens = 0
        domain = DOMAIN_PAIR if packing == "pair" else DOMAIN_QUAD
        markers = slot_markers(self.n_groups, key, domain=domain)
        dev = self.device
        self._marker_lanes = torch.from_numpy(marker_to_lanes(markers)).to(dev)
        b, n, p = batch, self.n_groups, page
        over_shape = ((b, n, p, n_kv, self.d2) if packing == "pair"
                      else (b, n, self.group_lanes - 1, p, n_kv, self.d2))

        def zeros(shape, dtype=torch.int16):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.state = {
            "pages": zeros((b, max_pages * p, n_kv, self.d2)),
            "slots": zeros((b, n, p, n_kv, self.d2)),
            "slots_overflow": zeros(over_shape),
            "strips": zeros((b, n, n_kv, self.d2 + MARKER_LANES)),
            "packed_mask": zeros((b, n), torch.bool),
            "predictor": zeros((b, n), torch.bool),
            "counter": torch.full((b,), counter_init, dtype=torch.int32,
                                  device=dev),
            "markers": torch.from_numpy(markers.view(np.int32).copy()).to(dev),
            "traffic": device_totals(dev),
            "pred_hits": zeros((b,), torch.int64),
            "pred_misses": zeros((b,), torch.int64),
            "packed_n": zeros((), torch.int64),
            "raw_n": zeros((), torch.int64),
        }
        # uniform appends: one host-side dirty mask covers every sequence
        self._dirty = np.zeros(self.n_groups, bool)
        # groups with data not yet fed to the §VI counter
        self._uncounted = np.zeros(self.n_groups, bool)
        self._last_enabled = np.full(batch, policy != "off", bool)
        self._host_stats = KVStats()
        self.ledger = ledger if ledger is not None else Ledger("kv")
        self.slot_bytes = page * n_kv * self.d2 * 2
        self.strip_bytes = n_kv * (self.d2 + MARKER_LANES) * 2

    @classmethod
    def auto(cls, tuner, k_sample, v_sample, *, max_pages: int, page: int,
             n_kv: int, head_dim: int, **kw):
        """`policy="auto"`: a `bandwidth.AutoTuner` picks the packing (off /
        pair / quad) from a sample of the KV stream, then the §VI dynamic
        gate runs over the chosen layout.  Returns (cache, PolicyChoice)."""
        d2 = 2 * head_dim
        choice = tuner.choose_kv_packing(
            k=k_sample, v=v_sample, page=page,
            slot_bytes=page * n_kv * d2 * 2,
            strip_bytes=n_kv * (d2 + MARKER_LANES) * 2)
        if choice.choice == "off":
            cache = cls(max_pages, page, n_kv, head_dim,
                        policy="off", packing="pair", **kw)
        else:
            cache = cls(max_pages, page, n_kv, head_dim, policy="auto",
                        packing=choice.choice, **kw)
        return cache, choice

    # the reference's pair-era names (the default packing is the pair)
    @property
    def n_pairs(self) -> int:
        return self.n_groups

    @property
    def host_stats(self) -> KVStats:
        """The host dispatch counters alone (pack_attempts, pack_calls,
        ...), with no device sync: timed loops read this, not `stats`."""
        return self._host_stats

    @property
    def stats(self) -> KVStats:
        """Host dispatch counters merged with the device tallies."""
        st = self.state
        with obs.d2h():
            packed, raw, hits, misses = torch.stack([
                st["packed_n"], st["raw_n"], st["pred_hits"].sum(),
                st["pred_misses"].sum()]).tolist()
        return replace(self._host_stats, packed_pairs=packed,
                       raw_pairs=raw, predictor_hits=hits,
                       predictor_misses=misses)

    def sync_ledger(self) -> None:
        """Window fold: absorb the device traffic accumulator into the host
        ledger, then reset it."""
        with obs.d2h():
            tot = self.state["traffic"].cpu().numpy()
        if tot.any():
            kv_window_fold(self.ledger, tot)
            self.state["traffic"] = device_totals(self.device)

    # ----------------------------------------------------------- appends
    def append(self, k, v):
        """k/v: (B, T, n_kv, d) — or (T, n_kv, d) when batch == 1."""
        kv = kv_bits(k, v, self.device)
        if kv.dim() == 3:
            assert self.batch == 1, "batched cache needs (B, T, n_kv, d)"
            kv = kv[None]
        bsz, t = kv.shape[:2]
        assert bsz == self.batch
        assert self.tokens + t <= self.max_pages * self.page, "cache full"
        self._scatter_tokens(kv)
        span = self.group_lanes * self.page
        lo = self.tokens // span
        hi = (self.tokens + t - 1) // span
        self._dirty[lo:hi + 1] = True
        self._uncounted[lo:hi + 1] = True
        self.tokens += t

    def _scatter_tokens(self, kv) -> None:
        """Write kv (B, T, Hkv, D2) at the cache's position, in place."""
        self.state["pages"][:, self.tokens:self.tokens + kv.shape[1]] = kv

    @property
    def n_pages(self) -> int:
        return (self.tokens + self.page - 1) // self.page

    @property
    def n_active_groups(self) -> int:
        return -(-self.n_pages // self.group_lanes)

    @property
    def n_active_pairs(self) -> int:
        return self.n_active_groups

    def valid_per_page(self) -> np.ndarray:
        """(B, max_pages) int32 valid tokens per logical page."""
        v = np.clip(self.tokens - np.arange(self.max_pages) * self.page,
                    0, self.page).astype(np.int32)
        return np.broadcast_to(v, (self.batch, self.max_pages)).copy()

    def pages_view(self):
        """Logical pages (B, max_pages, page, n_kv, d2)."""
        return self.state["pages"].reshape(
            self.batch, self.max_pages, self.page, self.n_kv, self.d2)

    def _groups_view(self):
        return self.state["pages"].reshape(
            self.batch, self.n_groups, self.group_lanes, self.page,
            self.n_kv, self.d2)

    def _tensor(self, x, dtype=None):
        """Host array -> tensor on the cache's device, copied without
        pinning: a small copy is staged at the call, a large one from
        pageable memory may wait for the card's queue (the `host.sync`
        span around it shows which)."""
        t = torch.as_tensor(np.asarray(x), dtype=dtype)
        with obs.h2d(t.nbytes):
            return t.to(self.device, non_blocking=True)

    # ------------------------------------------------------------- packing
    def enabled(self) -> np.ndarray:
        """(B,) bool: per-sequence compression gate (counter MSB, §VI)."""
        if self.policy == "off":
            return np.zeros(self.batch, bool)
        if self.policy == "static":
            return np.ones(self.batch, bool)
        with obs.d2h():
            counter = self.state["counter"].cpu().numpy()
        return counter >= ENABLE_THRESHOLD

    def _pack_window(self, win, idx_t, enabled):
        """Dispatch the gathered dirty window to the layout's kernels."""
        return kops.layout_window(win, self._marker_lanes[idx_t],
                                  self._tensor(enabled, torch.bool),
                                  use_pack=self.policy != "off")

    def _book_repack(self, w: int, enabled, lay) -> None:
        """Host dispatch counters + device byte/layout booking for one
        repack window."""
        hs = self._host_stats
        if self.policy == "off":
            hs.pack_skipped_dynamic += self.batch * w
        else:
            hs.pack_attempts += self.batch * w
            hs.pack_skipped_dynamic += int((~enabled).sum()) * w
        hs.pack_calls += 1
        hs.pack_pairs_processed += self.batch * w
        st = self.state
        _, lay_n = kv_repack_device(st["traffic"], lay,
                                    lanes=self.group_lanes,
                                    slot_bytes=self.slot_bytes,
                                    strip_bytes=self.strip_bytes)
        st["packed_n"] += lay_n
        st["raw_n"] += lay.numel() - lay_n

    def repack(self):
        """Incrementally re-pack the dirty groups (a clean cache returns
        before touching device state)."""
        idx = np.nonzero(self._dirty)[0]
        if idx.size == 0:
            return
        w = int(idx.size)
        enabled = self.enabled()
        idx_t = self._tensor(idx, torch.int64)
        win = self._groups_view()[:, idx_t]
        slots_w, over_w, strips_w, lay, fit = self._pack_window(
            win, idx_t, enabled)
        st = self.state
        scatter_window(st, idx_t, slots_w, over_w, strips_w, lay)
        self._book_repack(w, enabled, lay)
        # §VI: fitness of complete, not-yet-counted groups, measured even
        # while disabled; each group counted once, when it completes
        complete = (idx + 1) * self.group_lanes * self.page <= self.tokens
        if self.policy in ("dynamic", "auto"):
            countable = self._tensor(complete & self._uncounted[idx])
            counter_update(st["counter"], fit, countable[None, :])
        self._uncounted[idx[complete]] = False
        self._dirty[:] = False
        self._last_enabled = enabled
        flipped = self.enabled() != enabled
        if flipped.any():
            # a gate flip re-lays the whole active prefix at the next repack
            self._dirty[: self.n_active_groups] = True

    def reference_rebuild(self) -> dict:
        """From-scratch full pack of the active groups, per sequence, under
        the gate of the last repack — the bit-exactness oracle."""
        lanes = self.group_lanes
        n2 = lanes * self.n_active_groups
        pages = self.pages_view()[:, :n2]
        build = (kops.build_cram_cache if self.packing == "pair"
                 else kops.build_cram_cache_quad)
        out = []
        for bi in range(self.batch):
            if self._last_enabled[bi]:
                c = build(pages[bi], key=self.key)
            else:
                n = n2 // lanes
                grouped = pages[bi].reshape(
                    n, lanes, self.page, self.n_kv, self.d2)
                c = {
                    "slots": grouped[:, 0],
                    "slots_overflow": (grouped[:, 1] if lanes == 2
                                       else grouped[:, 1:]),
                    "strips": torch.zeros(
                        (n, self.n_kv, self.d2 + MARKER_LANES),
                        dtype=torch.int16, device=self.device),
                    "packed_mask": torch.zeros((n,), dtype=torch.bool,
                                               device=self.device),
                }
            out.append(c)
        keys = ("slots", "slots_overflow", "strips", "packed_mask")
        ref = {k: torch.stack([c[k] for c in out]) for k in keys}
        ref["markers"] = self.state["markers"][: n2 // lanes]
        return ref

    def active_state(self) -> dict:
        """The physical cache restricted to the active group prefix."""
        return self._kernel_cache(self.n_active_groups)

    # -------------------------------------------------------------- attend
    def _active_bucket(self) -> int:
        """Active group count rounded up to a power of two."""
        n = max(1, self.n_active_groups)
        return min(1 << (n - 1).bit_length(), self.n_groups)

    def _kernel_cache(self, n: int) -> dict:
        return kernel_cache_slice(self.state, n)

    def _valid(self, n: int):
        return self._tensor(self.valid_per_page()[:, : self.group_lanes * n])

    def account_step(self) -> dict:
        """One decode step's bandwidth accounting + LLP predictor update,
        into the device accumulators."""
        self.repack()
        return self._account()

    def _absorb_step(self, raw_seq, cram_seq, valid, n: int) -> dict:
        """Fold one decode step's byte columns and predictor observation
        into the device accumulators."""
        st = self.state
        pm = st["packed_mask"][:, :n]
        pred = st["predictor"][:, :n]
        live = valid.reshape(pm.shape[0], n, self.group_lanes).sum(-1) > 0
        mis = pred != pm
        st["pred_hits"] += ((~mis) & live).sum(1)
        st["pred_misses"] += (mis & live).sum(1)
        kv_read_device(st["traffic"], raw_seq, cram_seq)
        st["predictor"].copy_(observe_layout(st["packed_mask"]))
        raw_t, cram_t = raw_seq.sum(), cram_seq.sum()
        return {"raw_bytes": raw_t, "cram_bytes": cram_t,
                "raw_per_seq": raw_seq, "cram_per_seq": cram_seq,
                "saving": 1.0 - cram_t / torch.clamp(raw_t, min=1)}

    def _account(self) -> dict:
        n = self._active_bucket()
        valid = self._valid(n)
        raw_seq, cram_seq = kops.hbm_bytes_moved_device(
            self._kernel_cache(n), valid,
            predictor=self.state["predictor"][:, :n], lanes=self.group_lanes)
        return self._absorb_step(raw_seq, cram_seq, valid, n)

    def _q(self, q):
        q = torch.as_tensor(q, device=self.device)
        return q[None] if q.dim() == 2 else q

    def _attend_inputs(self):
        """Repack (span `cache.repack`), then what an attend reads: the
        active bucket `n`, the state's kernel slice of `n` groups and its
        valid counts."""
        with obs.span("cache.repack"):
            self.repack()
        n = self._active_bucket()
        return n, self._kernel_cache(n), self._valid(n)

    def attend(self, q, *, account: bool = True):
        """q: (B, Hq, d) one query row per sequence -> (B, Hq, d) float32,
        with per-step bandwidth accounting from the kernel's byte output
        (`account=False` for parity probes that must not charge a step)."""
        n, kc, valid = self._attend_inputs()
        out, raw_seq, cram_seq = kops.decode_attention_fused(
            self._q(q), kc, valid,
            self.state["predictor"][:, :n] if account else None,
            lanes=self.group_lanes)
        if account:
            self._absorb_step(raw_seq, cram_seq, valid, n)
        return out

    def attend_ref(self, q):
        """Oracle (plain torch) attention over the same physical state."""
        _, kc, valid = self._attend_inputs()
        decode = (kops.decode_attention_ref_batched
                  if self.packing == "pair"
                  else kops.decode_attention_quad_ref_batched)
        return decode(self._q(q), kc, valid)

    def saving(self) -> float:
        """Cumulative decode-bandwidth saving from the ledger's "kv" read
        rows, after folding the pending device window."""
        self.sync_ledger()
        return self.ledger.saving("read", consumer="kv")
