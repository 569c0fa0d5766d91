"""Traffic kind `hybrid_decode`: the `decode` kind's closed batch of
greedy sequences through the port's serve step
(`launch/steps.py:make_serve_step` -> `DecoderLM.decode_step`), for a
model of the `pattern` family: Mamba-2, MoE and attention blocks in a
published layer pattern (Nemotron-H).

The set-up writes each sequence's context from the seed, as if the same
`prefix` positions had been read: K/V for the attention blocks, and the
conv contexts and h of the Mamba-2 blocks.  The recurrence overwrites
the Mamba-2 state in place, so each cohort writes it again from the seed
when it starts (inside its first step); the K/V past the prefix is
simply written over.  Cohorts, first tokens and the served tokens are
the `decode` kind's.

After the window one more decode step of the program, the probe, runs
for a cohort of its own from the seeded context and records what each
block was given and gave.  The check holds each block to the plain
float32 reference (`reference/nemotron_h.py`) on the program's own
input, so each block reads its own rounding: at full depth bf16 flips
routing choices near ties, and the served sequences drift from the
reference's as far as float8's do.  It also runs the reference over the
cohort in flight at the window's close (its served tokens, the attention
blocks' new cache rows, and each Mamba-2 block's h at the close) and
over the last cohort that finished (its served tokens); of those
readings only `own_gap` and the first Mamba-2 block's h part a sound
program from the control.  The counts the per-layer metrics divide by
(`flops`, `min_bytes`, `ssm_min_bytes`) are this file's: the
yardstick's cover the dense and moe families only."""

from __future__ import annotations

import math

import torch

from portbench import yardstick
from portbench.drivers import decode
from portbench.reference import decoder as dec
from portbench.reference import nemotron_h as ref

STATE_SCALE = 0.1       # the seeded h: N(0, 1) x this
BIAS_SCALE = 0.02       # the router's correction bias: N(0, 1) x this
CONV_BIAS_SCALE = 0.2   # the conv biases: N(0, 1) x this
DT_MIN, DT_MAX, DT_FLOOR = 1e-3, 0.1, 1e-4


# --------------------------------------------------------------- weights

def layer_shapes(cfg: dict, kind: str) -> dict[str, tuple]:
    """One block's normal-drawn tensors {name: shape}, named as the
    port's state dict names them inside `blocks.{i}.`."""
    d, hd = cfg["d_model"], yardstick.head_dim(cfg)
    if kind == "attn":
        hq, hkv = cfg["n_heads"], cfg["n_kv_heads"]
        return {"attn.wq": (d, hq * hd), "attn.wk": (d, hkv * hd),
                "attn.wv": (d, hkv * hd), "attn.wo": (hq * hd, d)}
    if kind == "moe":
        e, f = cfg["n_experts"], cfg["d_ff"]
        out = {"moe.router": (d, e), "moe.w1": (e, d, f),
               "moe.w2": (e, f, d)}
        if cfg.get("router", "softmax") == "sigmoid_bias":
            out["moe.bias"] = (e,)
        if cfg.get("shared_expert_ff"):
            fs = cfg["shared_expert_ff"]
            out.update({"moe.shared.w1": (d, fs), "moe.shared.w2": (fs, d)})
        return out
    s = ref.ssm_dims(cfg)
    din, gn, k = s["din"], s["g"] * s["n"], s["k"]
    out = {"ssm.wz": (d, din), "ssm.wx": (d, din), "ssm.wB": (d, gn),
           "ssm.wC": (d, gn), "ssm.wdt": (d, s["heads"]),
           "ssm.conv_x": (k, din), "ssm.conv_B": (k, gn),
           "ssm.conv_C": (k, gn), "ssm.out": (din, d)}
    if cfg.get("ssm_conv_bias"):
        out.update({"ssm.conv_x_bias": (din,), "ssm.conv_B_bias": (gn,),
                    "ssm.conv_C_bias": (gn,)})
    return out


def _scale(name: str, shape: tuple) -> float:
    """normal / sqrt(fan_in) (the conv's fan-in is its taps), the router
    at 0.02, the biases at their own scales."""
    if name.endswith("router"):
        return 0.02
    if name.endswith("moe.bias"):
        return BIAS_SCALE
    if name.endswith("_bias"):
        return CONV_BIAS_SCALE
    return 1.0 / math.sqrt(shape[-2])


def _ssm_constants(cfg: dict, g, device) -> dict:
    """A_log, dt_bias, D and the norm as HF's Mamba-2 init makes them:
    A = 1 .. H, dt_bias the inverse softplus of a dt drawn log-uniformly
    in [DT_MIN, DT_MAX] (at least DT_FLOOR), D and the norm ones."""
    s = ref.ssm_dims(cfg)
    nh = s["heads"]
    u = torch.rand((nh,), generator=g, device=device)
    t = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                  + math.log(DT_MIN)).clamp(min=DT_FLOOR)
    return {"ssm.A_log": torch.log(torch.arange(1, nh + 1, device=device,
                                                dtype=torch.float32)),
            "ssm.dt_bias": t + torch.log(-torch.expm1(-t)),
            "ssm.D": torch.ones((nh,), device=device),
            "ssm.norm": torch.ones((s["din"],), device=device)}


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded weights in the served dtype with exactly `init_lm`'s keys
    and shapes, made on `device` in one draw a block (and one for the
    embedding, one for the untied head).  The norms are ones."""
    dt = yardstick.DTYPES[cfg["param_dtype"]]
    d, v = cfg["d_model"], cfg["vocab"]
    g = yardstick.generator(device, seed, "weights")
    out = {"embed": torch.randn((v, d), generator=g, device=device,
                                dtype=dt).mul_(0.02),
           "final_ln": torch.ones((d,), dtype=dt, device=device)}
    if not cfg.get("tie_embeddings", True):
        out["head"] = torch.randn((v, d), generator=g, device=device,
                                  dtype=dt).mul_(0.02)
    for i, kind in enumerate(ref.layer_kinds(cfg)):
        shapes = layer_shapes(cfg, kind)
        flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                           generator=g, device=device, dtype=dt)
        pre, at = f"blocks.{i}.", 0
        out[pre + "ln1"] = torch.ones((d,), dtype=dt, device=device)
        for name, shape in shapes.items():
            n = math.prod(shape)
            out[pre + name] = flat[at:at + n].view(shape).mul_(
                _scale(name, shape))
            at += n
        if kind == "ssm":
            for name, t in _ssm_constants(cfg, g, device).items():
                out[pre + name] = t.to(dt)
    return out


# ---------------------------------------------------------------- counts

def _block_params(cfg: dict, kind: str, experts: float) -> float:
    """A block's parameters, with `experts` of its routed experts."""
    total = cfg["d_model"]                                  # ln1
    for name, shape in layer_shapes(cfg, kind).items():
        n = math.prod(shape)
        total += n / cfg["n_experts"] * experts if name in (
            "moe.w1", "moe.w2") else n
    if kind == "ssm":
        s = ref.ssm_dims(cfg)
        total += 3 * s["heads"] + s["din"]          # A_log, dt_bias, D; norm
    return total


def _matmul_params(cfg: dict, kind: str) -> float:
    """The weights of a block's matrix products that one token uses: its
    projections, the router, its top-k experts and the shared one."""
    skip = ("moe.bias", "ssm.conv_x", "ssm.conv_B", "ssm.conv_C")
    total = 0.0
    for name, shape in layer_shapes(cfg, kind).items():
        if name.startswith(skip):
            continue
        n = math.prod(shape)
        total += n / cfg["n_experts"] * cfg["top_k"] if name in (
            "moe.w1", "moe.w2") else n
    return total


def ssm_token_flops(cfg: dict) -> float:
    """A Mamba-2 block's FLOPs a token beyond its projections: the conv,
    2 K (d_inner + 2 G N), and the state's update and read, 5 H N P
    (decay, the outer product and its sum, C h)."""
    s = ref.ssm_dims(cfg)
    return (2.0 * s["k"] * (s["din"] + 2 * s["g"] * s["n"])
            + 5.0 * s["heads"] * s["n"] * s["p"])


def ssm_state_bytes(cfg: dict) -> float:
    """One sequence's float32 state of one Mamba-2 block: h and the three
    conv contexts."""
    s = ref.ssm_dims(cfg)
    return 4.0 * (s["heads"] * s["n"] * s["p"]
                  + (s["k"] - 1) * (s["din"] + 2 * s["g"] * s["n"]))


def step_flops(cfg: dict, contexts) -> float:
    """Model FLOPs of one decode step of len(contexts) sequences: 2 x the
    matrix weights a token uses x the tokens (with the output head),
    attention's 4 x context x Hq x hd a block, and the Mamba-2 blocks'
    conv and state."""
    kinds = ref.layer_kinds(cfg)
    b = len(contexts)
    per_token = (sum(_matmul_params(cfg, k) for k in kinds)
                 + cfg["vocab"] * cfg["d_model"])
    return (2.0 * per_token * b
            + yardstick.attention_flops(contexts, cfg["n_heads"],
                                        yardstick.head_dim(cfg),
                                        kinds.count("attn"))
            + b * kinds.count("ssm") * ssm_token_flops(cfg))


def ssm_min_bytes(cfg: dict, batch: int) -> float:
    """Least bytes the Mamba-2 blocks of one decode step move: their
    weights read once in the served dtype, each sequence's state read and
    written once."""
    wb = yardstick.DTYPES[cfg["param_dtype"]].itemsize
    per = (_block_params(cfg, "ssm", 0) - cfg["d_model"]) * wb \
        + 2 * batch * ssm_state_bytes(cfg)
    return ref.layer_kinds(cfg).count("ssm") * per


def step_min_bytes(cfg: dict, contexts) -> float:
    """Least bytes one decode step moves: every weight it uses read once
    in the served dtype (every expert a token routes to, in expectation),
    the K/V of every attended position read once and the new rows
    written once, the Mamba-2 state read and written once, the token
    embeddings read and the float32 logits written."""
    wb = yardstick.DTYPES[cfg["param_dtype"]].itemsize
    ab = yardstick.DTYPES[cfg["dtype"]].itemsize
    kinds = ref.layer_kinds(cfg)
    b = len(contexts)
    experts = yardstick.expected_experts(cfg, b)
    weights = sum(_block_params(cfg, k, experts) for k in kinds)
    weights += cfg["d_model"] + cfg["vocab"] * cfg["d_model"]  # final_ln, head
    row = 2 * cfg["n_kv_heads"] * yardstick.head_dim(cfg) * ab
    kv = row * float(sum(contexts)) * kinds.count("attn")
    state = 2 * b * ssm_state_bytes(cfg) * kinds.count("ssm")
    return (weights * wb + kv + state + b * cfg["d_model"] * wb
            + b * cfg["vocab"] * 4)


# ---------------------------------------------------------------- driver

class Driver(decode.Driver):
    def __init__(self, config: dict, cell: dict, seed: int, device):
        # the program's config first: a port without the pattern family
        # fails here, before anything is allocated
        self.model_cfg = decode.model_config(config["model"])
        super().__init__(config, cell, seed, device)
        self.kinds = ref.layer_kinds(self.cfg)

    # ------------------------------------------------------------ inputs
    def _state(self, layer: int) -> dict:
        """Mamba-2 block `layer`'s seeded context, float32 (B, ...): the
        conv contexts N(0, 1) in the compute dtype's values, h N(0, 1) x
        STATE_SCALE."""
        s = ref.ssm_dims(self.cfg)
        gn = s["g"] * s["n"]
        shapes = {"conv_x": (s["k"] - 1, s["din"]),
                  "conv_B": (s["k"] - 1, gn), "conv_C": (s["k"] - 1, gn),
                  "h": (s["heads"], s["n"], s["p"])}
        g = yardstick.generator(self.device, self.seed, "state", layer)
        cdt = yardstick.DTYPES[self.cfg["dtype"]]
        out = {}
        for name, shape in shapes.items():
            t = torch.randn((self.batch, *shape), generator=g,
                            device=self.device)
            out[name] = (t.mul_(STATE_SCALE) if name == "h"
                         else t.to(cdt).to(torch.float32))
        return out

    def _cache_leaf(self, layer: int, which: str):
        return self.cache[f"b{layer}"]["attn"][which][0]

    def _write_state(self) -> None:
        for layer, kind in enumerate(self.kinds):
            if kind == "ssm":
                leaves = self.cache[f"b{layer}"]["ssm"]
                for name, t in self._state(layer).items():
                    leaves[name][0].copy_(t)
                    del t

    # ------------------------------------------------------------- serve
    def setup(self) -> None:
        from repro_torch.launch.steps import make_serve_step
        from repro_torch.models import build

        weights = make_weights(self.cfg, self.seed, self.device)
        self.model = build(self.model_cfg, device=self.device,
                           params=weights)
        del weights
        self.cache = self.model.init_cache(self.batch, self.cache_len)
        for layer, kind in enumerate(self.kinds):
            if kind == "attn":
                for which, kv in zip("kv", self._prefix(layer), strict=True):
                    self._cache_leaf(layer, which)[:, :self.prefix] = kv
        decode_step = self.model.decode_step

        def kept(*a, **kw):
            self.logits = decode_step(*a, **kw)
            return self.logits

        self.model.decode_step = kept
        self.serve_step = make_serve_step(self.model)
        self.cohorts: list = []
        self.own_max = torch.zeros((), device=self.device)
        self._start_cohort("warm-up")
        for _ in range(2):
            self.step()
        self.cohorts, self.steps_done, self.contexts = [], 0, []
        self.own_max.zero_()
        self.cohort = -1

    def _start_cohort(self, key) -> None:
        super()._start_cohort(key)
        self._write_state()

    # ------------------------------------------------------------- check
    def finish(self) -> None:
        """Keep what the check judges (the served tokens, the in-flight
        cohort's new attention rows and its Mamba-2 h at the close), run
        the probe step (`_probe`) and free the rest of the program's
        state."""
        self.judged, self.own_gap = [], float(self.own_max)
        idx = self.row_seqs.to(self.device)
        for i, (_, first, served, n, own) in enumerate(self.cohorts):
            rows = states = None
            if i == len(self.cohorts) - 1:
                sl = slice(self.prefix, self.prefix + n)
                rows = {layer: tuple(self._cache_leaf(layer, w)[idx, sl]
                                     .clone() for w in "kv")
                        for layer, kind in enumerate(self.kinds)
                        if kind == "attn"}
                # on the host: the probe step writes the state over
                states = {layer: self.cache[f"b{layer}"]["ssm"]["h"][0]
                          .to("cpu", copy=True)
                          for layer, kind in enumerate(self.kinds)
                          if kind == "ssm"}
            self.judged.append((first, served[:, :n].clone(), n, rows,
                                states))
            self.own_gap = max(self.own_gap, float(own[:, :n].max()))
        self.probe = self._probe()
        del self.model, self.cache, self.serve_step, self.cohorts, self.tok
        del self.logits

    def _probe(self) -> list[dict]:
        """One more decode step of the program, `decode_step` as served,
        for a cohort of its own from the seeded context (position
        `prefix`, the Mamba-2 state written from the seed), recording
        each block's input "x" and its mixer's output "y" (which the
        block adds to x), an attention block's "o" (the decode
        attention's output, before the out projection) and new cache
        rows "k", "v", a Mamba-2 block's h after the step, and the
        step's logits (with the last block's output "x_out").  The check
        holds each block to the reference on the program's own input, so
        what one block's rounding does to the next does not add up."""
        from repro_torch.models import attention, transformer

        last: dict = {}

        def keep(fn, key):
            def kept(*a, **kw):
                out = fn(*a, **kw)
                last[key] = (out[0] if isinstance(out, tuple)
                             else out).clone()
                return out
            return kept

        blocks: list[dict] = []
        block = self.model._block

        def recorded(kind, w, x, **kw):
            last.clear()
            out = block(kind, w, x, **kw)
            blocks.append({"x": x.clone(), "x_out": out[0].clone(), **last})
            return out

        patched = [(transformer, "ssm_decode_step", "y"),
                   (transformer, "attention_apply", "y"),
                   (transformer, "moe_apply", "y"),
                   (attention, "chunked_decode_attention", "o")]
        saved = [getattr(m, n) for m, n, _ in patched]
        self._write_state()
        tok = self._first_tokens("probe")
        for (m, n, key), fn in zip(patched, saved, strict=True):
            setattr(m, n, keep(fn, key))
        self.model._block = recorded
        try:
            logits = self.model.decode_step(tok, self.cache, self.prefix)
        finally:
            del self.model._block
            for (m, n, _), fn in zip(patched, saved, strict=True):
                setattr(m, n, fn)
        for layer, (kind, rec) in enumerate(zip(self.kinds, blocks,
                                                strict=True)):
            if kind == "ssm":
                rec["h"] = self.cache[f"b{layer}"]["ssm"]["h"][0].to(
                    "cpu", copy=True)
            elif kind == "attn":
                for w in "kv":
                    rec[w] = self._cache_leaf(layer, w)[:, self.prefix] \
                        .clone()
        blocks[-1]["logits"] = logits.clone()
        return blocks

    def check(self, *, control: bool = False) -> dict:
        """The probe's readings (`_probe_readings`); the `decode` kind's
        (`own_gap`, `logit_gap`, `logit_gap_p50`, `mismatch_share`,
        `cache_rel_err` and its median, over the attention blocks); and
        `state_rel_err` and its median: the worst Mamba-2 block's
        relative error of h (all sequences) at the window's close;
        `state_rel_err_first`, the first Mamba-2 block's, whose input
        (the embedding rows) is the reference's exactly.  Past the first
        blocks the served sequences drift from the reference's in bf16
        (23 sigmoid routers flip top-6 choices near ties) as far as in
        float8, so of these only `own_gap` and `state_rel_err_first`
        tell a sound program from the control.  With `control`, the
        float8 reference's readings in the program's place."""
        weights = make_weights(self.cfg, self.seed, self.device)
        out = self._probe_readings(weights, control)
        idx = self.row_seqs.to(self.device)
        out_w = ref.head(weights)
        gaps, errs, state_errs = [], [], []
        for first, served, n, rows, states in self.judged:
            served = served.to(torch.int64)
            tokens = torch.cat([first, served[:, :n - 1]], 1)
            want_rows, want_h = {}, {}
            judged = rows is not None

            def keep_rows(i, k, v, d):
                d[i] = (k[idx], v[idx])

            h = ref.forward(
                self.cfg, weights, self._prefix, self._state, tokens,
                self.prefix,
                on_layer=(lambda i, k, v: keep_rows(i, k, v, want_rows))
                if judged else None,
                on_state=want_h.__setitem__ if judged else None)
            got_rows, got_h = rows or {}, states or {}
            if control:
                got_rows, got_h = {}, {}
                hc = ref.forward(
                    self.cfg, weights, self._prefix, self._state, tokens,
                    self.prefix, control=True,
                    on_layer=(lambda i, k, v: keep_rows(i, k, v, got_rows))
                    if judged else None,
                    on_state=got_h.__setitem__ if judged else None)
                served = dec.argmax_tokens(hc, out_w, control=True)
                del hc
            gaps.append(dec.logit_gaps(h, out_w, served).reshape(-1))
            for i, (rk, rv) in want_rows.items():
                for got, want in zip(got_rows[i], (rk, rv), strict=True):
                    errs.append(_rel(got, want))
            for i, want in sorted(want_h.items()):
                state_errs.append(_rel(got_h[i], want))
            del h
        g = torch.cat(gaps)
        out.update({"own_gap": 0.0 if control else self.own_gap,
                    "logit_gap": float(g.max()),
                    "logit_gap_p50": float(g.median()),
                    "mismatch_share": float((g > 0).to(torch.float32)
                                            .mean())})
        if errs:
            out["cache_rel_err"] = max(errs)
            out["cache_rel_err_p50"] = float(torch.tensor(errs).median())
        if state_errs:
            out["state_rel_err"] = max(state_errs)
            out["state_rel_err_p50"] = float(torch.tensor(state_errs)
                                             .median())
            out["state_rel_err_first"] = state_errs[0]
        return out

    def _probe_readings(self, weights: dict, control: bool) -> dict:
        """Each block of the probe step against the reference's block on
        the program's own input (and, where it has one, the seeded
        context it started from); the worst block of each kind:
        `probe_ssm_err` (a Mamba-2 block's output: projections, conv,
        state, grouped gated norm, out projection), `probe_ssm_h_err`
        (its h after the step), `probe_moe_err` (a MoE block's output,
        the router's choices included) and `probe_moe_err_p50` (the
        median over the batch of each sequence's error: a choice flipped
        near a tie moves one sequence, not the median),
        `probe_attn_o_err` (the decode attention's output before the out
        projection), `probe_attn_err` (the attention block's output),
        `probe_attn_rows_err` (its new K and V rows); and
        `probe_logits_err` (the final norm and the output head on the
        last block's output).  All relative errors in the norm.  With
        `control`, the float8 reference on the same inputs in the
        program's place."""
        worst: dict = {}

        def judge(name, got, want):
            worst[name] = max(worst.get(name, 0.0), _rel(got, want))

        with ref.exact():
            for i, (kind, rec) in enumerate(zip(self.kinds, self.probe,
                                                strict=True)):
                x = rec["x"].to(torch.float32)
                ctx = {"prefix": self._prefix(i)} if kind == "attn" else {
                    "state": self._state(i)} if kind == "ssm" else {}
                want = ref.block(self.cfg, weights, i, x, self.prefix, **ctx)
                got = (ref.block(self.cfg, weights, i, x, self.prefix,
                                 control=True, **ctx) if control else
                       {"y": rec["y"], "h": rec.get("h"),
                        "o": rec.get("o"), "k": rec.get("k"),
                        "v": rec.get("v")})
                name = {"ssm": "probe_ssm", "moe": "probe_moe",
                        "attn": "probe_attn"}[kind]
                judge(name + "_err", got["y"], want["y"])
                if kind == "ssm":
                    judge("probe_ssm_h_err", got["h"], want["h"])
                elif kind == "moe":
                    per = (torch.linalg.vector_norm(
                        got["y"].to(torch.float32) - want["y"], dim=-1)
                        / torch.linalg.vector_norm(want["y"], dim=-1))
                    worst["probe_moe_err_p50"] = max(
                        worst.get("probe_moe_err_p50", 0.0),
                        float(per.median()))
                else:
                    judge("probe_attn_o_err",
                          got["o"].reshape(want["o"].shape), want["o"])
                    for w in "kv":
                        judge("probe_attn_rows_err",
                              got[w].reshape(want[w].shape), want[w])
                del want, got
            x_out = self.probe[-1]["x_out"].to(torch.float32)[:, 0]
            want = ref.logits(self.cfg, weights, x_out)
            got = (ref.logits(self.cfg, weights, x_out, control=True)
                   if control else self.probe[-1]["logits"])
            judge("probe_logits_err", got, want)
        return worst

    def record(self, traced: dict) -> dict:
        """This file's counts over the traced steps."""
        ctx = self.contexts[traced["first"]:traced["last"]]
        steps = len(ctx)
        return {"steps": steps, "tokens": steps * self.batch,
                "flops": sum(step_flops(self.cfg, [c] * self.batch)
                             for c in ctx),
                "min_bytes": sum(step_min_bytes(self.cfg, [c] * self.batch)
                                 for c in ctx),
                "ssm_min_bytes": steps * ssm_min_bytes(self.cfg,
                                                       self.batch)}


def _rel(got, want) -> float:
    want = want.to(torch.float32)
    got = got.to(want.device, torch.float32).reshape(want.shape)
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))
