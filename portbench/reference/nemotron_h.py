"""The plain float32 reference of the pattern-family decoder the hybrid
decode cell serves (Nemotron-H: Mamba-2, MoE and attention blocks in a
published layer pattern), in plain torch, importing nothing of the
program.

As `decoder.forward`, it runs a cohort's served tokens in one pass,
block by block, from the context the benchmark seeds: each attention
block's prefix K/V (`prefix(i)`) and each Mamba-2 block's conv and h
state (`state(i)`).  Every matrix product runs in float32 with TF32 off;
the helpers (`linear` and its float8 control, `rms_norm`, `attend`,
`capacity`, the logits) are `decoder.py`'s.

The equations (the port's, which the benchmark judges), by block, each
x + mixer(rms_norm(x, ln1)):
  * "M", Mamba-2: z, x, B, C and dt projected from the block's input;
    x, B and C through a depthwise causal conv of K taps with a bias
    over the prefix's last K-1 inputs, then SiLU; dt = softplus(dt +
    dt_bias); per head, h' = exp(dt A) h + dt B x^T (A = -exp(A_log), B
    and C shared by the heads of a group), y = C h' + D x; y * SiLU(z)
    RMS-normed over each of `ssm_norm_groups` groups of d_inner, then the
    out projection.  The recurrence runs token by token (no chunked
    form).
  * "E", MoE with no attention: sigmoid scores of float32 router logits;
    the top-k experts by score plus `moe.bias` (ties to the lower
    expert); gates the chosen unbiased scores, renormalised over the k
    and multiplied by `routed_scale`; the port's capacity rule in each
    decode step over the batch (`decoder.moe`'s); relu^2 experts
    (relu(x W1)^2 W2) plus the shared expert on every token.
  * "*", attention with no MLP: GQA over the prefix and the new rows,
    rotated only where `rope` is set (Nemotron-H applies none).
  * An untied output head (`head`) when `tie_embeddings` is false.
RMS norms take the config's `norm_eps` (1e-6 where it names none).

`block` computes one block from a given input and context, so that a
check can hold each block of the program to the reference on the
program's own input (`forward` chains the same function).

`control=True` puts every matrix product through float8 e4m3, as
`decoder.py` does; the recurrences stay float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import decoder as dec

KINDS = {"M": "ssm", "E": "moe", "*": "attn"}
SCORES = 1 << 28        # attention's scores held at once, in elements


def layer_kinds(cfg: dict) -> list[str]:
    return [KINDS[c] for c in cfg["layer_pattern"]]


def rms_norm(cfg: dict, x, w):
    """x (..., n) float32 RMS-normed over its last dim, times w."""
    eps = cfg.get("norm_eps", 1e-6)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x * w.to(torch.float32)


def ssm_dims(cfg: dict) -> dict:
    din = cfg.get("ssm_inner") or cfg.get("ssm_expand", 2) * cfg["d_model"]
    return {"din": din, "heads": din // cfg["ssm_headdim"],
            "p": cfg["ssm_headdim"], "n": cfg["ssm_state"],
            "g": cfg.get("ssm_ngroups", 1), "k": cfg.get("ssm_conv", 4),
            "norm_groups": cfg.get("ssm_norm_groups", 1)}


def _mlp(cfg: dict, w: dict, x, control: bool):
    """relu^2 (w1, w2) or SwiGLU (w1, w3, w2)."""
    h = dec.linear(x, w["w1"], control)
    if cfg.get("mlp_act", "swiglu") == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.silu(h) * dec.linear(x, w["w3"], control)
    return dec.linear(h, w["w2"], control)


def choose(cfg: dict, w: dict, xs, control: bool = False):
    """xs (..., D) float32 -> (gates, eidx) (..., k): the router's choice
    (module docstring)."""
    k = cfg["top_k"]
    logits = dec.linear(xs, w["router"], control)
    if cfg.get("router", "softmax") == "sigmoid_bias":
        scores = torch.sigmoid(logits)
        eidx = torch.sort(scores + w["bias"].to(torch.float32), dim=-1,
                          descending=True, stable=True).indices[..., :k]
        gates = scores.gather(-1, eidx)
    else:
        srt = torch.sort(torch.softmax(logits, dim=-1), dim=-1,
                         descending=True, stable=True)
        gates, eidx = srt.values[..., :k], srt.indices[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates * cfg.get("routed_scale", 1.0), eidx


def moe(cfg: dict, w: dict, x, control: bool):
    """x (B, n, D): each of the n positions is one decode step whose batch
    is the B sequences.  -> (B, n, D)."""
    b, n, d = x.shape
    e, k = cfg["n_experts"], cfg["top_k"]
    cap = dec.capacity(cfg, b)
    xs = x.transpose(0, 1)                                  # (n, B, D)
    gates, eidx = choose(cfg, w, xs, control)
    onehot = F.one_hot(eidx.reshape(n, b * k), e)
    rank = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)   # (n, B*k)
    keep = (rank < cap).reshape(n, b, k)
    y = torch.zeros((n * b, d), dtype=torch.float32, device=x.device)
    flat_x = xs.reshape(n * b, d)
    for ex in range(e):
        sel = (eidx == ex) & keep
        tok = sel.any(-1).reshape(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        gate = (gates * sel).sum(-1).reshape(-1)[tok]
        out = _mlp(cfg, {n_: t[ex] for n_, t in w.items()
                         if n_ in ("w1", "w2", "w3")}, flat_x[tok], control)
        y.index_add_(0, tok, out * gate[:, None])
    y = y.reshape(n, b, d).transpose(0, 1)
    if cfg.get("shared_expert_ff"):
        y = y + _mlp(cfg, {n_[7:]: t for n_, t in w.items()
                           if n_.startswith("shared.")}, x, control)
    return y


def _conv(u, w, state, bias):
    """Depthwise causal conv of u (B, n, C) after the K-1 inputs of
    `state` (B, K-1, C), plus the bias, then SiLU."""
    k, n = w.shape[0], u.shape[1]
    up = torch.cat([state, u], 1)
    y = sum(up[:, i:i + n] * w[i].to(torch.float32) for i in range(k))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return F.silu(y)


def ssm(cfg: dict, w: dict, x, state: dict, control: bool):
    """x (B, n, D), the block's normed input; `state` {conv_x, conv_B,
    conv_C, h} float32, the state before the first position (not
    changed) -> (the block's output (B, n, D), h after the last
    position (B, H, N, P))."""
    b, n, _ = x.shape
    s = ssm_dims(cfg)
    nh, hp, ns, g = s["heads"], s["p"], s["n"], s["g"]
    f32 = torch.float32
    z = dec.linear(x, w["wz"], control)
    xin = _conv(dec.linear(x, w["wx"], control), w["conv_x"],
                state["conv_x"], w.get("conv_x_bias"))
    bb = _conv(dec.linear(x, w["wB"], control), w["conv_B"],
               state["conv_B"], w.get("conv_B_bias"))
    cc = _conv(dec.linear(x, w["wC"], control), w["conv_C"],
               state["conv_C"], w.get("conv_C_bias"))
    dt = F.softplus(dec.linear(x, w["wdt"], control)
                    + w["dt_bias"].to(f32))                 # (B, n, H)
    a = -torch.exp(w["A_log"].to(f32))
    dd = w["D"].to(f32)
    h = state["h"].clone()
    ys = []
    for t in range(n):
        bt = bb[:, t].reshape(b, g, ns).repeat_interleave(nh // g, 1)
        ct = cc[:, t].reshape(b, g, ns).repeat_interleave(nh // g, 1)
        xt = xin[:, t].reshape(b, nh, hp)
        dtt = dt[:, t]                                      # (B, H)
        h = (h * torch.exp(dtt * a)[..., None, None]
             + (bt * dtt[..., None])[..., None] * xt[:, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", ct, h) + xt * dd[:, None])
    y = torch.stack(ys, 1).reshape(b, n, s["din"]) * F.silu(z)
    y = rms_norm(cfg, y.reshape(b, n, s["norm_groups"], -1),
                 w["norm"].reshape(s["norm_groups"], -1))
    return dec.linear(y.reshape(b, n, s["din"]), w["out"], control), h


def forward(cfg: dict, weights: dict, prefix, state, tokens, start: int, *,
            control: bool = False, on_layer=None, on_state=None):
    """tokens (B, n) at positions start .. start+n-1 after a context of
    `start` positions (`prefix(i)` -> (k, v), each (B, start, Hkv, hd),
    of attention block i; `state(i)` -> the float32 {conv_x, conv_B,
    conv_C, h} of Mamba-2 block i) -> final hidden states (B, n, D)
    float32.  `on_layer(i, k, v)` sees each attention block's new cache
    rows, `on_state(i, h)` each Mamba-2 block's h after the last
    position."""
    with exact():
        return _forward(cfg, weights, prefix, state, tokens, start,
                        control, on_layer, on_state)


class exact:
    """Inside: float32 matrix products with TF32 off (`block`, `logits`
    and `forward` are meant to run inside)."""

    def __enter__(self):
        self.tf32 = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.tf32


def _forward(cfg, weights, prefix, state, tokens, start, control, on_layer,
             on_state):
    x = weights["embed"].to(torch.float32)[tokens]          # (B, n, D)
    for i, kind in enumerate(layer_kinds(cfg)):
        out = block(cfg, weights, i, x, start,
                    prefix=prefix(i) if kind == "attn" else None,
                    state=state(i) if kind == "ssm" else None,
                    control=control)
        if kind == "ssm" and on_state is not None:
            on_state(i, out["h"])
        if kind == "attn" and on_layer is not None:
            on_layer(i, out["k"], out["v"])
        x = x + out["y"]
    return rms_norm(cfg, x, weights["final_ln"])


def block_weights(weights: dict, i: int):
    """Block i's (ln1, {mixer weight: tensor}), the mixer's names without
    their `ssm.` / `moe.` / `attn.` prefix."""
    pre = f"blocks.{i}."
    w = {key[len(pre):]: t for key, t in weights.items()
         if key.startswith(pre)}
    return w["ln1"], {k.split(".", 1)[1]: t for k, t in w.items() if "." in k}


def block(cfg: dict, weights: dict, i: int, x, start: int, *, prefix=None,
          state=None, control: bool = False) -> dict:
    """Block i's mixer on its input x (B, n, D) float32 at positions
    start .. start+n-1, after its context: `prefix` (k, v), each (B,
    start, Hkv, hd), for an attention block; `state` {conv_x, conv_B,
    conv_C, h} for a Mamba-2 block.  -> {"y": the mixer's output (B, n,
    D), which the block adds to x; a Mamba-2 block's "h" after the last
    position; an attention block's "o" (B, n, Hq, hd), before the out
    projection, and its new rows "k", "v" (B, n, Hkv, hd)}."""
    kind = layer_kinds(cfg)[i]
    ln1, w = block_weights(weights, i)
    h = rms_norm(cfg, x, ln1)
    if kind == "ssm":
        y, hs = ssm(cfg, w, h, state, control)
        return {"y": y, "h": hs}
    if kind == "moe":
        return {"y": moe(cfg, w, h, control)}
    b, n, _ = x.shape
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    hq, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    q = dec.linear(h, w["wq"], control).reshape(b, n, hq, hd)
    k = dec.linear(h, w["wk"], control).reshape(b, n, hkv, hd)
    v = dec.linear(h, w["wv"], control).reshape(b, n, hkv, hd)
    if cfg.get("rope", True):
        pos = torch.arange(start, start + n, device=x.device)
        q = dec.rope(q, pos, cfg["rope_theta"])
        k = dec.rope(k, pos, cfg["rope_theta"])
    k_pre, v_pre = prefix
    o = dec.attend(q, k_pre, v_pre, k, v,
                   block=max(1, SCORES // (hq * n * (start + n))))
    return {"y": dec.linear(o.reshape(b, n, hq * hd), w["wo"], control),
            "o": o, "k": k, "v": v}


def logits(cfg: dict, weights: dict, x, control: bool = False):
    """The last block's output x (..., D) float32 -> float32 logits (...,
    V): the final norm and the output head."""
    return dec.linear(rms_norm(cfg, x, weights["final_ln"]),
                      head(weights).t(), control)


def head(weights: dict):
    """The output head's (V, D) weight: `head`, or the tied embedding."""
    return weights.get("head", weights["embed"])
