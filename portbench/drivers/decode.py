"""Traffic kind `decode`: a closed batch of sequences decoding greedily
through the port's serve step (`launch/steps.py:make_serve_step` ->
`DecoderLM.decode_step`) at full depth.

Each sequence has a context of `prefix` positions whose K/V the set-up
writes into the model's cache from the seed (the port has no bulk
prefill into its cache); a cohort then feeds each sequence a seeded
first token at position `prefix` and decodes `tokens` tokens.  When a
cohort ends the next starts from the same prefix, with new first tokens.

The check runs the plain float32 reference over the cohort in flight at
the window's close (its served tokens and the cache rows they wrote) and
over the last cohort that finished, if any (its served tokens)."""

from __future__ import annotations

import contextlib

import torch

from portbench import trace as tr
from portbench import yardstick
from portbench.reference import decoder as ref

ROW_SEQS = 64       # sequences whose new cache rows the check compares


def model_config(model: dict):
    from repro_torch.models import ModelConfig

    kw = dict(model)
    for key in ("dtype", "param_dtype"):
        kw[key] = yardstick.DTYPES[kw[key]]
    return ModelConfig(**kw)


class Driver:
    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.cfg = config["model"]
        t = cell["traffic"]
        self.batch, self.prefix = int(t["batch"]), int(t["prefix"])
        self.cohort_len, self.cache_len = int(t["tokens"]), int(t["cache_len"])
        if self.prefix + self.cohort_len > self.cache_len:
            raise ValueError("a cohort does not fit the cache: prefix "
                             f"{self.prefix} + tokens {self.cohort_len} > "
                             f"cache_len {self.cache_len}")
        self.seed, self.device = seed, device
        self.per = (max(self.cfg.get("moe_every", 1), 1)
                    if self.cfg["family"] == "moe" else 1)
        self.steps_done = 0
        self.contexts: list[int] = []       # positions attended, by step
        # the sequences whose cache rows the check compares, from the seed
        self.row_seqs = torch.from_numpy(yardstick.permutation(
            seed, self.batch, "rows")[:ROW_SEQS]).sort().values

    # ------------------------------------------------------------ inputs
    def _prefix(self, layer: int):
        """Layer `layer`'s seeded context K/V, (B, prefix, Hkv, hd)."""
        shape = (self.batch, self.prefix, self.cfg["n_kv_heads"],
                 yardstick.head_dim(self.cfg))
        dt = yardstick.DTYPES[self.cfg["dtype"]]
        return tuple(torch.randn(shape, generator=yardstick.generator(
            self.device, self.seed, "prefix", layer, j), device=self.device,
            dtype=dt) for j in range(2))

    def _first_tokens(self, cohort):
        g = yardstick.generator(self.device, self.seed, "cohort", cohort)
        return torch.randint(0, self.cfg["vocab"], (self.batch, 1),
                             generator=g, device=self.device)

    def _cache_leaf(self, layer: int, which: str):
        return self.cache[f"b{layer % self.per}"]["attn"][which][
            layer // self.per]

    # ------------------------------------------------------------- serve
    def setup(self) -> None:
        from repro_torch.launch.steps import make_serve_step
        from repro_torch.models import build

        weights = yardstick.make_weights(self.cfg, self.seed, self.device)
        self.model = build(model_config(self.cfg), device=self.device,
                           params=weights)
        del weights
        self.cache = self.model.init_cache(self.batch, self.cache_len)
        for layer in range(self.cfg["n_layers"]):
            for which, kv in zip("kv", self._prefix(layer), strict=True):
                self._cache_leaf(layer, which)[:, :self.prefix] = kv
        decode_step = self.model.decode_step

        def kept(*a, **kw):
            self.logits = decode_step(*a, **kw)
            return self.logits

        self.model.decode_step = kept
        self.serve_step = make_serve_step(self.model)
        self.cohorts: list = []     # [cohort, first, served, n, own gaps]
        self.own_max = torch.zeros((), device=self.device)
        self._start_cohort("warm-up")
        for _ in range(2):
            self.step()
        self.cohorts, self.steps_done, self.contexts = [], 0, []
        self.own_max.zero_()
        self.cohort = -1

    def _start_cohort(self, key) -> None:
        first = self._first_tokens(key)
        served = torch.empty((self.batch, self.cohort_len), dtype=torch.int32,
                             device=self.device)
        own = torch.zeros((self.batch, self.cohort_len), dtype=torch.float32,
                          device=self.device)
        if len(self.cohorts) == 2:          # fold the dropped cohort's gaps
            self.own_max = torch.maximum(self.own_max,
                                         self.cohorts[0][4].max())
        self.cohorts = self.cohorts[-1:] + [[key, first, served, 0, own]]
        self.tok = first

    def begin(self) -> None:
        pass

    def step(self) -> int:
        cur = self.cohorts[-1] if self.cohorts else None
        if cur is None or cur[3] == self.cohort_len:
            self.cohort += 1
            self._start_cohort(self.cohort)
            cur = self.cohorts[-1]
        pos = cur[3]
        self.tok, _ = self.serve_step(self.tok, self.cache, self.prefix + pos)
        cur[2][:, pos] = self.tok[:, 0]
        # greedy: how far the served token's logit lies below the best of
        # the logits the step returned
        cur[4][:, pos] = (self.logits.amax(1)
                          - self.logits.gather(1, self.tok.long())[:, 0])
        cur[3] = pos + 1
        self.steps_done += 1
        self.contexts.append(self.prefix + pos + 1)
        return self.batch

    @contextlib.contextmanager
    def spans(self):
        """Spans around the decode attention and the MoE layer, opened
        from here around the program's own functions."""
        from repro_torch.models import attention, transformer

        patched = [(attention, "chunked_decode_attention", "decode.attention"),
                   (transformer, "moe_apply", "decode.moe")]
        saved = [getattr(m, n) for m, n, _ in patched]

        for (m, n, label), fn in zip(patched, saved, strict=True):
            setattr(m, n, tr.wrapped(fn, label))
        step, self.serve_step = self.serve_step, tr.wrapped(self.serve_step,
                                                      "decode.step")
        try:
            yield
        finally:
            for (m, n, _), fn in zip(patched, saved, strict=True):
                setattr(m, n, fn)
            self.serve_step = step

    # ------------------------------------------------------------- check
    def finish(self) -> None:
        """Keep what the check judges (the served tokens, the in-flight
        cohort's cache rows) and free the program's state."""
        self.judged, self.own_gap = [], float(self.own_max)
        for i, (key, first, served, n, own) in enumerate(self.cohorts):
            rows = None
            if i == len(self.cohorts) - 1:
                sl = slice(self.prefix, self.prefix + n)
                idx = self.row_seqs.to(self.device)
                rows = [tuple(self._cache_leaf(layer, w)[idx, sl].clone()
                              for w in "kv")
                        for layer in range(self.cfg["n_layers"])]
            self.judged.append((first, served[:, :n].clone(), n, rows))
            self.own_gap = max(self.own_gap, float(own[:, :n].max()))
        del self.model, self.cache, self.serve_step, self.cohorts, self.tok
        del self.logits

    def check(self, *, control: bool = False) -> dict:
        """The readings of the served tokens and cache rows against the
        reference: the widest and the median gap by which a served
        token's logit lies below the reference's best, the share of
        served tokens that are not the reference's first, and the worst
        and the median relative error of a layer's new K or V rows; and,
        from the program's side alone, the widest gap by which a served
        token's logit lies below the best of the logits its step returned
        (0 for greedy decoding: `own_gap`).  With
        `control`, the readings of the float8 reference put in the
        program's place instead."""
        weights = yardstick.make_weights(self.cfg, self.seed, self.device)
        idx = self.row_seqs.to(self.device)
        gaps, errs = [], []
        for first, served, n, rows in self.judged:
            served = served.to(torch.int64)
            tokens = torch.cat([first, served[:, :n - 1]], 1)
            ref_rows: dict = {}

            def keep(i, k, v, rows=rows, ref_rows=ref_rows):
                if rows is not None:
                    ref_rows[i] = (k[idx], v[idx])

            h = ref.forward(self.cfg, weights, self._prefix, tokens,
                            self.prefix, on_layer=keep)
            got_rows = dict(enumerate(rows)) if rows else {}
            if control:
                got_rows = {}
                hc = ref.forward(self.cfg, weights, self._prefix, tokens,
                                 self.prefix, control=True,
                                 on_layer=lambda i, k, v, d=got_rows:
                                 d.__setitem__(i, (k[idx], v[idx])))
                served = ref.argmax_tokens(hc, weights["embed"],
                                           control=True)
                del hc
            gaps.append(ref.logit_gaps(h, weights["embed"], served)
                        .reshape(-1))
            for i, (rk, rv) in ref_rows.items():
                for got, want in zip(got_rows[i], (rk, rv), strict=True):
                    errs.append(float(torch.linalg.vector_norm(
                        got.to(torch.float32) - want)
                        / torch.linalg.vector_norm(want)))
            del h
        g = torch.cat(gaps)
        out = {"own_gap": 0.0 if control else self.own_gap,
               "logit_gap": float(g.max()),
               "logit_gap_p50": float(g.median()),
               "mismatch_share": float((g > 0).to(torch.float32).mean())}
        if errs:
            out["cache_rel_err"] = max(errs)
            out["cache_rel_err_p50"] = float(torch.tensor(errs).median())
        return out

    def record(self, traced: dict) -> dict:
        """The yardstick's counts over the traced steps."""
        ctx = self.contexts[traced["first"]:traced["last"]]
        steps = len(ctx)
        return {"steps": steps, "tokens": steps * self.batch,
                "flops": sum(yardstick.decode_step_flops(
                    self.cfg, [c] * self.batch) for c in ctx),
                "min_bytes": sum(yardstick.decode_step_min_bytes(
                    self.cfg, [c] * self.batch) for c in ctx)}
