"""Traffic kind `kv_tier`: long-context sessions served by the port's
CRAM-KV tier (`serving/loop.py:ServeLoop`) at a model's KV geometry,
with no model layer: each step appends one token of every session's KV
stream through the fused megastep (K1/K2) and attends a seeded query for
every session (K3).

Sessions fill every slot.  Their prompt lengths are spread evenly over
[prompt_min, prompt_max] and a fixed share of each block of `slots`
sessions is compressible, in an order drawn from the seed; the streams
are made on the card from the seed (a device copy of the port's
`synthetic_kv_stream`).  The set-up bulk-packs the first sessions
(`ServeLoop.prefill`) as if each had already decoded an evenly spread
part of its `decode_tokens`; a session that has decoded them all
retires, and the next one is admitted by one bulk pack inside the
window.

The check compares the attends of every `check_every`-th step (the
phase from the seed) with plain attention over the raw streams, and the
layout bytes the megastep booked over the window with the reference's
count of which page groups fit."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import trace as tr
from portbench import yardstick
from portbench.reference import kv as ref


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        m, t = config["model"], cell["traffic"]
        self.n_kv, self.hd = m["n_kv_heads"], yardstick.head_dim(m)
        self.n_heads = m["n_heads"]
        self.t, self.seed, self.device = t, seed, device
        self.slots, self.page = int(t["slots"]), int(t["page"])
        self.decode = int(t["decode_tokens"])
        self.chunk = int(t["chunk"])
        self.slot_b, self.strip_b = yardstick.slot_bytes(self.page, self.n_kv,
                                                         self.hd)
        self.steps_done = 0
        self.log: list = []            # (sids, lengths) after each step
        self.kept: list = []           # (step, sids, lengths, q, out)
        self.at_end = None
        self.phase = int(yardstick.permutation(seed, int(t["check_every"]),
                                               "check")[0])

    # ------------------------------------------------------------ inputs
    def _session(self, j: int) -> tuple:
        """(prompt length, compressible) of the j-th session, and the part
        of its decode budget already spent when it is one of the first
        `slots`: every block of `slots` sessions holds the same lengths
        and the same number of compressible ones, in a seeded order."""
        s, t = self.slots, self.t
        b, i = divmod(j, s)
        lo, hi = int(t["prompt_min"]), int(t["prompt_max"])
        rank = yardstick.permutation(self.seed, s, "prompt", b)[i]
        length = lo + int((hi - lo) * (rank + 0.5) / s)
        n_comp = round(float(t["compressible_share"]) * s)
        comp = bool(yardstick.permutation(self.seed, s, "kind", b)[i] < n_comp)
        done = (int(yardstick.permutation(self.seed, s, "done")[i])
                * self.decode // s) if b == 0 else 0
        return length, comp, done

    def _tokens(self, sid: int, start: int, stop: int):
        _, comp, _ = self._session(sid)
        return yardstick.kv_tokens(self.device, self.seed, sid, start, stop,
                                   self.n_kv, self.hd, chunk=self.chunk,
                                   compressible=comp,
                                   scale=float(self.t["scale"]))

    def _admit(self, sid: int) -> None:
        prompt, _, done = self._session(sid)
        k, v = self._tokens(sid, 0, prompt + done)
        self.loop.prefill(sid, k, v)
        self.live[sid] = {"len": prompt + done, "left": self.decode - done,
                          "chunk": -1}

    def _row(self, sid: int):
        s = self.live[sid]
        c, r = divmod(s["len"], self.chunk)
        if s["chunk"] != c:
            s["chunk"] = c
            s["k"], s["v"] = self._tokens(sid, c * self.chunk,
                                          (c + 1) * self.chunk)
        return s["k"][r:r + 1], s["v"][r:r + 1]

    # ------------------------------------------------------------- serve
    def setup(self) -> None:
        from repro_torch.serving import ServeLoop

        t = self.t
        self.loop = ServeLoop(
            slots=self.slots, page=self.page, n_kv=self.n_kv,
            head_dim=self.hd, policy=t["policy"], packing=t["packing"],
            max_pages=-(-(int(t["prompt_max"]) + self.decode) // self.page),
            device=self.device)
        cache = self.loop.cache
        booked = [torch.zeros((), dtype=torch.int64, device=self.device)
                  for _ in range(2)]
        megastep = cache.megastep

        def counted(*a, **kw):
            out = megastep(*a, **kw)
            booked[0] += out["raw_per_seq"].sum()
            booked[1] += out["cram_per_seq"].sum()
            return out

        cache.megastep = counted
        self.booked = booked
        self.live: dict = {}
        for sid in range(self.slots):
            self._admit(sid)
        self.next_sid = self.slots
        self.gq = yardstick.generator(self.device, self.seed, "queries")
        for _ in range(2):
            self.step()
        self.steps_done, self.log, self.kept = 0, [], []

    def counters(self) -> dict:
        st = self.loop.cache.state
        c = self.loop.cache
        live = -(-c.tokens_b // (c.group_lanes * c.page))
        mask = (torch.arange(c.n_groups, device=self.device)[None, :]
                < torch.as_tensor(live, device=self.device)[:, None])
        return {"raw": int(self.booked[0]), "cram": int(self.booked[1]),
                "hits": int(st["pred_hits"].to(torch.int64).sum()),
                "misses": int(st["pred_misses"].to(torch.int64).sum()),
                "packed": int((st["packed_mask"] & mask).sum()),
                "groups": int(mask.sum())}

    def begin(self) -> None:
        self.at_begin = self.counters()

    def step(self) -> int:
        for sid in [s for s, x in self.live.items() if x["left"] == 0]:
            self.loop.retire(sid)
            del self.live[sid]
            self._admit(self.next_sid)
            self.next_sid += 1
        sids = sorted(self.live)
        self.loop.step_all({sid: self._row(sid) for sid in sids})
        for sid in sids:
            self.live[sid]["len"] += 1
            self.live[sid]["left"] -= 1
        q = torch.randn((len(sids), self.n_heads, self.hd), generator=self.gq,
                        device=self.device)
        out = self.loop.attend({sid: q[i] for i, sid in enumerate(sids)})
        lengths = [self.live[sid]["len"] for sid in sids]
        self.log.append((sids, lengths))
        if self.steps_done % int(self.t["check_every"]) == self.phase:
            self.kept.append((self.steps_done, sids, lengths, q,
                              torch.stack([out[s] for s in sids])))
        self.steps_done += 1
        return len(sids)

    @contextlib.contextmanager
    def spans(self):
        """Spans around the tier's step and attend, and a count of the
        booked bytes and the predictor before and after."""
        loop = self.loop
        step_all, attend = loop.step_all, loop.attend

        self.at_trace = self.counters()
        loop.step_all, loop.attend = (tr.wrapped(step_all, "kv.step"),
                                      tr.wrapped(attend, "kv.attend"))
        try:
            yield
        finally:
            loop.step_all, loop.attend = step_all, attend
            self.at_end = self.counters()

    # ------------------------------------------------------------- check
    def finish(self) -> None:
        self.at_close = self.at_end or self.counters()
        self.loop.spill.flush()
        del self.loop, self.live, self.booked

    def _layout(self, sid: int, length: int):
        k, v = self._tokens(sid, 0, length)
        return k, v, ref.Layout(k, v, page=self.page, slot=self.slot_b,
                                strip=self.strip_b)

    def check(self, *, control: bool = False) -> dict:
        """The readings of the window's attends and booked bytes against
        the reference: the worst and the median attend error (the largest
        |difference| of a session's output over its rms), and how far the
        layout and raw bytes booked over the window lie from the
        reference's count.  With `control`, the attend readings of the
        TF32 reference put in the program's place instead."""
        last = {}
        for sids, lengths in self.log:
            for sid, n in zip(sids, lengths, strict=True):
                last[sid] = n
        steps_layout = np.zeros(len(self.log), np.int64)
        steps_raw = np.zeros(len(self.log), np.int64)
        by_sid: dict = {}
        for i, (sids, lengths) in enumerate(self.log):
            for sid, n in zip(sids, lengths, strict=True):
                by_sid.setdefault(sid, []).append((i, n))
        kept_by_sid: dict = {}
        for j, (_, sids, lengths, q, out) in enumerate(self.kept):
            for r, sid in enumerate(sids):
                kept_by_sid.setdefault(sid, []).append((j, r, lengths[r]))
        errs = []
        for sid, seen in by_sid.items():
            k, v, lay = self._layout(sid, last[sid])
            for i, n in seen:
                steps_layout[i] += lay.bytes(n)
                steps_raw[i] += lay.raw_bytes(n)
            if sid in kept_by_sid:
                rows = kept_by_sid[sid]
                q = torch.stack([self.kept[j][3][r] for j, r, _ in rows])
                got = torch.stack([self.kept[j][4][r] for j, r, _ in rows])
                n = torch.tensor([x for *_, x in rows], device=self.device)
                want = ref.attention(q, k, v, n, control=control)
                if control:
                    got, want = want, ref.attention(q, k, v, n)
                rms = want.pow(2).mean(dim=(1, 2)).sqrt().clamp(min=1e-30)
                e = (got - want).abs().amax(dim=(1, 2)) / rms
                errs.append(e)
            del k, v, lay
        self.steps_layout, self.steps_raw = steps_layout, steps_raw
        a, b = self.at_begin, self.at_close
        layout_booked = ((b["cram"] - a["cram"])
                         - self.slot_b * (b["misses"] - a["misses"]))
        e = torch.cat(errs)
        return {
            "attend_err": float(e.max()),
            "attend_err_p50": float(e.median()),
            "layout_bytes_gap": abs(layout_booked - int(steps_layout.sum())),
            "raw_bytes_gap": abs((b["raw"] - a["raw"])
                                 - int(steps_raw.sum())),
        }

    def record(self, traced: dict) -> dict:
        lo, hi = traced["first"], traced["last"]
        a, b, c = self.at_begin, self.at_trace, self.at_end
        steps = hi - lo
        tokens = sum(len(s) for s, _ in self.log[lo:hi])
        attended = sum(sum(n) for _, n in self.log[lo:hi])
        k3 = sum(yardstick.k3_bytes(float(self.steps_layout[i]),
                                    len(self.log[i][0]), self.n_heads,
                                    self.hd) for i in range(lo, hi))
        row = self.n_kv * 2 * self.hd * 2
        window_tokens = sum(len(s) for s, _ in self.log)
        return {
            "steps": steps, "tokens": tokens,
            "attend_flops": yardstick.attention_flops([attended],
                                                      self.n_heads, self.hd,
                                                      1),
            "k3_bytes": k3, "min_bytes": k3 + tokens * row,
            "packed_groups": c["packed"], "live_groups": c["groups"],
            "llp_hits": c["hits"] - b["hits"],
            "llp_misses": c["misses"] - b["misses"],
            "kv_read_bytes": c["cram"] - a["cram"],
            "kv_tokens": window_tokens,
        }
