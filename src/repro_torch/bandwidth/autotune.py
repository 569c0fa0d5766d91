"""The §VI gate generalised into a policy engine over the codec registry
(port of `repro.bandwidth.autotune`; host code, numpy and the page codecs
on CPU tensors).

Given ledger telemetry and/or `--sweep codecs` ratio tables, the
AutoTuner selects

  * the KV packing layout per stream and per tier — "off" | "pair" |
    "quad",
  * the checkpoint line codec per tensor class — "raw" or any registered
    line64 codec,
  * the gradient-collective codec — "off" | "int8".

A candidate is chosen only when its expected bytes per access beat the
uncompressed baseline by at least `margin` (the paper's no-slowdown
guarantee); ties and losses fall back to "off" / "raw".  On top of the
expectation model, `observe(ledger)` runs the §VI saturating counter per
decision key over measured savings, window by window, so a consumer whose
live traffic stops compressing is gated off, and re-enabled when
compressible traffic returns.  Everything is deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..compression import codecs as _codecs
from ..compression.framing import LINE_BYTES
from ..compression.gate import (
    COUNTER_INIT,
    ENABLE_THRESHOLD,
    counter_enabled,
    counter_step,
)
from .ledger import Ledger

KV_PACKINGS = ("off", "pair", "quad")
# page codec backing each packing choice (registry names)
KV_PAGE_CODEC = {"pair": "int8-delta", "quad": "int4-delta"}
# one observation window is worth this many counter ticks
OBSERVE_TICKS = 256


@dataclass(frozen=True)
class PolicyChoice:
    """One autotune decision with its evidence, JSON-ready."""

    target: str                    # "kv" | "kv-spill" | "checkpoint" | "grad"
    choice: str                    # selected registry entry / packing
    expected: dict = field(default_factory=dict)   # candidate -> bytes/unit
    basis: str = "tables"          # "tables" | "probe" | "ledger"
    preferred: str = ""            # the model's pick before a disabled §VI
                                   # gate forced "off"; a live re-enable
                                   # migrates to this

    def as_dict(self) -> dict:
        return {"target": self.target, "choice": self.choice,
                "expected": dict(self.expected), "basis": self.basis,
                "preferred": self.preferred}


def kv_expected_bytes_per_page(fit_rate: float, lanes: int,
                               slot_bytes: float = 1.0,
                               strip_bytes: float | None = None) -> float:
    """Expected decode bytes per page under a packing layout: a packed
    group costs one slot + strip for all `lanes` pages, an unpacked group
    slot + strip per page.  The "off" baseline is `slot_bytes` a page."""
    if strip_bytes is None:
        strip_bytes = slot_bytes / 8.0   # strip ~ one row of a page-8 slot
    packed_group = slot_bytes + strip_bytes
    raw_group = lanes * (slot_bytes + strip_bytes)
    return (fit_rate * packed_group + (1.0 - fit_rate) * raw_group) / lanes


def kv_spill_bytes_per_page(fit_rate: float, lanes: int,
                            slot_bytes: float = 1.0,
                            page: int | None = None) -> float:
    """Expected bytes per page crossing the spill link per evict/restore,
    after the `serving.SpillStore` payload: a fitting group moves one
    packed slot plus its base row (`slot_bytes / page`, default page 8),
    an unfitting group its pages raw; no strips.  The "off" baseline is
    `slot_bytes` a page."""
    base_bytes = slot_bytes / (page if page else 8)
    packed_group = slot_bytes + base_bytes
    raw_group = lanes * slot_bytes
    return (fit_rate * packed_group + (1.0 - fit_rate) * raw_group) / lanes


def _host_f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def probe_kv_fit_rates(k, v, *, page: int, max_groups: int = 64) -> dict:
    """Pair/quad pack-fit rates of a sample KV stream.

    k/v: (B, T, Hkv, D) or (T, Hkv, D) floats, arrays or tensors.  The
    bf16 bit patterns are the float32 words' high halves (truncated, as in
    the reference's probe; the cache itself rounds to nearest).  Pages
    group per sequence, as the cache lays them out.  Returns
    {"pair": r, "quad": r}."""
    k, v = _host_f32(k), _host_f32(v)
    if k.ndim == 3:
        k, v = k[None], v[None]
    kv = np.concatenate([k, v], axis=-1)
    bf16 = np.ascontiguousarray(
        (kv.view("<u4") >> 16).astype("<u2")).view("<i2")
    b, t = bf16.shape[:2]
    n_pages = t // page
    pages = torch.from_numpy(np.ascontiguousarray(
        bf16[:, : n_pages * page].reshape(b, n_pages, page,
                                          *bf16.shape[2:])))
    rates = {}
    for packing, lanes in (("pair", 2), ("quad", 4)):
        codec = _codecs.get_codec(KV_PAGE_CODEC[packing])
        fits = []
        for bi in range(b):
            for gi in range(n_pages // lanes):
                if len(fits) >= max_groups:
                    break
                grp = pages[bi, gi * lanes:(gi + 1) * lanes]
                ok, _, _ = codec.pack_pages(*grp)
                fits.append(bool(ok))
        rates[packing] = float(np.mean(fits)) if fits else 0.0
    return rates


class AutoTuner:
    """Policy engine over the codec/layout registry (module docstring)."""

    def __init__(self, *, tables: dict | None = None, margin: float = 0.02,
                 counter_init: int = COUNTER_INIT):
        self.tables = tables or {}
        self.margin = float(margin)
        self._counter_init = int(counter_init)
        self._counters: dict[str, int] = {}   # §VI counter per decision key
        # per-key ledger snapshot: observe() judges the traffic since the
        # last observation of that key, not the ledger's lifetime totals
        self._last_totals: dict[str, tuple[int, int]] = {}

    @classmethod
    def from_codec_sweep(cls, report: dict, **kw) -> "AutoTuner":
        """Build from a `--sweep codecs` report (or its "codecs" section)."""
        return cls(tables=report.get("codecs", report), **kw)

    # ------------------------------------------------ §VI ledger-driven gate
    def observe(self, ledger: Ledger, *, key: str, consumer=None,
                tensor_class=None, event=None) -> int:
        """One saturating-counter step for `key` from the traffic recorded
        since the previous observe() of that key: benefit when the window
        saved at least `margin`, cost when it saved less than nothing.  An
        empty window leaves the counter as it is.  Returns the counter."""
        t = ledger.total(event, consumer=consumer, tensor_class=tensor_class)
        raw, comp = t["raw_bytes"], t["compressed_bytes"]
        last_raw, last_comp = self._last_totals.get(key, (0, 0))
        self._last_totals[key] = (raw, comp)
        raw_d, comp_d = raw - last_raw, comp - last_comp
        c = self._counters.get(key, self._counter_init)
        if raw_d <= 0:
            self._counters[key] = c
            return c
        saving = 1.0 - comp_d / raw_d
        benefit = OBSERVE_TICKS if saving >= self.margin else 0
        cost = OBSERVE_TICKS if saving < 0.0 else 0
        c = int(counter_step(np.int64(c), cost, benefit, np))
        self._counters[key] = c
        return c

    def gate_enabled(self, key: str) -> bool:
        """Counter MSB for a decision key (enabled until proven harmful)."""
        return bool(counter_enabled(
            self._counters.get(key, self._counter_init)))

    def counter(self, key: str) -> int:
        return self._counters.get(key, self._counter_init)

    # --------------------------------------------------------- KV packing
    def choose_kv_packing(self, fit_rates: dict | None = None, *,
                          k=None, v=None, page: int | None = None,
                          slot_bytes: float = 1.0,
                          strip_bytes: float | None = None,
                          stream: str | None = None,
                          tier: str = "hot",
                          gate_key: str | None = None) -> PolicyChoice:
        """Pick off/pair/quad from fit rates (given, probed from a k/v
        sample, or read from the codec-sweep kv_pages tables).  `tier`
        "hot" judges under the decode model (`kv_expected_bytes_per_page`),
        "spill" under the spill-link model (`kv_spill_bytes_per_page`);
        each tier has its own gate key ("kv" / "kv-spill" by default)."""
        assert tier in ("hot", "spill"), tier
        if gate_key is None:
            gate_key = "kv" if tier == "hot" else "kv-spill"
        basis = "tables"
        if fit_rates is None and k is not None:
            assert page is not None, "probe needs the page size"
            fit_rates = probe_kv_fit_rates(k, v, page=page)
            basis = "probe"
        if fit_rates is None:
            row = self.tables.get("kv_pages", {}).get(stream or "", {})
            fit_rates = {
                p: float(row.get(KV_PAGE_CODEC[p], {}).get("fit_rate", 0.0))
                for p in ("pair", "quad")
            }
        expected = {"off": float(slot_bytes)}
        for packing, lanes in (("pair", 2), ("quad", 4)):
            fr = float(fit_rates.get(packing, 0.0))
            expected[packing] = (
                kv_expected_bytes_per_page(fr, lanes, slot_bytes,
                                           strip_bytes)
                if tier == "hot" else
                kv_spill_bytes_per_page(fr, lanes, slot_bytes, page))
        choice = min(expected, key=lambda p: (expected[p],
                                              KV_PACKINGS.index(p)))
        # no-slowdown guarantee: a packing must beat "off" by the margin
        if expected[choice] > expected["off"] * (1.0 - self.margin):
            choice = "off"
        preferred = choice
        if not self.gate_enabled(gate_key):
            choice = "off"
        target = "kv" if tier == "hot" else "kv-spill"
        return PolicyChoice(target, choice, expected, basis, preferred)

    # --------------------------------------------------- checkpoint codec
    def choose_ckpt_codec(self, sample_lines=None, *,
                          tensor_class: str | None = None,
                          max_lines: int = 4096,
                          gate_key: str = "checkpoint") -> PolicyChoice:
        """The line codec with the smallest mean compressed size over a
        sample of 64-byte lines; "raw" unless it beats raw by the margin.
        With no sample, the codec-sweep `tensors` ratio table for the
        tensor class decides."""
        names = list(_codecs.codec_names("line64"))
        if sample_lines is not None:
            lines = np.asarray(sample_lines, np.uint8).reshape(-1, LINE_BYTES)
            if lines.shape[0] > max_lines:
                stride = lines.shape[0] // max_lines
                lines = lines[::stride][:max_lines]
            expected = {
                n: float(np.asarray(
                    _codecs.get_codec(n).sizes(lines)).mean())
                for n in names
            }
            basis = "probe"
        else:
            row = self.tables.get("tensors", {}).get(tensor_class or "", {})
            expected = {
                n: LINE_BYTES / float(row[n]) if n in row else
                float(LINE_BYTES)
                for n in names
            }
            basis = "tables"
        choice = min(expected, key=lambda n: (expected[n], names.index(n)))
        if (expected[choice] > expected["raw"] * (1.0 - self.margin)
                or not self.gate_enabled(gate_key)):
            choice = "raw"
        return PolicyChoice("checkpoint", choice, expected, basis)

    # ------------------------------------------------------- grad codec
    def choose_grad_codec(self, rel_err: float, *,
                          err_budget: float = 0.05,
                          bytes_saving: float = 0.75,
                          gate_key: str = "grad") -> PolicyChoice:
        """int8 collective iff the measured relative quantization error is
        within budget and the gate is on."""
        expected = {"off": 1.0, "int8": 1.0 - float(bytes_saving)}
        ok = (float(rel_err) <= float(err_budget)
              and self.gate_enabled(gate_key))
        return PolicyChoice("grad", "int8" if ok else "off", expected,
                            "probe")

    # ----------------------------------------------------------- combined
    def choose(self, telemetry: dict) -> dict:
        """Full policy from a telemetry dict with any of: kv_fit_rates |
        (kv_sample_k, kv_sample_v, page); ckpt_samples ({tensor_class:
        lines}); grad_rel_err."""
        out: dict = {}
        if "kv_fit_rates" in telemetry:
            out["kv"] = self.choose_kv_packing(telemetry["kv_fit_rates"])
        elif "kv_sample_k" in telemetry:
            out["kv"] = self.choose_kv_packing(
                k=telemetry["kv_sample_k"], v=telemetry["kv_sample_v"],
                page=telemetry["page"])
        for tc, lines in telemetry.get("ckpt_samples", {}).items():
            out[f"checkpoint:{tc}"] = self.choose_ckpt_codec(
                lines, tensor_class=tc)
        if "grad_rel_err" in telemetry:
            out["grad"] = self.choose_grad_codec(telemetry["grad_rel_err"])
        return out


__all__ = [
    "AutoTuner", "PolicyChoice", "KV_PACKINGS", "KV_PAGE_CODEC",
    "OBSERVE_TICKS", "kv_expected_bytes_per_page", "kv_spill_bytes_per_page",
    "probe_kv_fit_rates",
    "COUNTER_INIT", "ENABLE_THRESHOLD",
]
