"""The plain float32 reference of the decoder LM the decode cells serve
(the dense and MoE families of the port's `DecoderLM`), in plain torch,
importing nothing of the program.

It runs a prompt's served tokens in one pass, layer by layer, over a
cache prefix it is given (the benchmark's seeded prefix K/V), and
returns the final hidden states; `logit_gaps` turns them into the gap
by which each served token's logit lies below the reference's best.
Every matrix product runs in float32 with TF32 off.

What it follows and where it departs from the published models (the
port's equations, which the benchmark judges):
  * RMS norm (eps 1e-6) in float32 with a weight; pre-norm residual
    blocks; the output head is the embedding, tied.
  * RoPE on the whole head ("rotate half", theta from the config), q
    and k; Phi-4-mini publishes a partial rotary factor and LongRoPE
    scaling, which the port leaves out.
  * GQA: KV head j serves query heads j*G .. j*G+G-1; softmax over the
    valid positions with scale 1/sqrt(hd).
  * SwiGLU MLP silu(x W1) * (x W3) W2.
  * MoE: a softmax router, the top-k experts by probability (ties to the
    lower expert), gates renormalised over the k (OLMoE publishes
    `norm_topk_prob: false`), and the port's capacity dispatch: in each
    decode step the B tokens of the batch (in batch order) fill each
    expert's C = int(B k / E * capacity_factor + 0.999) rows by (token,
    choice) order, and a choice beyond them adds nothing.  OLMoE is
    published without a capacity and with QK norms, which the port's
    config leaves out.

`control=True` computes every matrix product with both operands
quantised to float8 e4m3 (per-row scales for the activations, per
output column for the weights), the precision below the configuration's
bf16."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6
FP8_MAX = 448.0


def _q8(x, dim):
    """x rounded through float8 e4m3 with an absmax scale over `dim`."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def linear(x, w, control: bool):
    """x (..., n) @ w (n, m) in float32; in the control, both rounded to
    float8 first (x per row, w per output column)."""
    w = w.to(torch.float32)
    if control:
        return _q8(x, -1) @ _q8(w, -2)
    return x @ w


def rms_norm(x, w):
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS)
    return x * w.to(torch.float32)


def rope(x, positions, theta: float):
    """x (B, n, H, hd) float32, positions (n,) -> rotated ("rotate
    half")."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions.to(torch.float32)[:, None] * freqs      # (n, hd/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend(q, k_pre, v_pre, k, v, block: int = 8):
    """q (B, n, Hq, hd) of positions P..P+n-1 against the prefix k_pre /
    v_pre (B, P, Hkv, hd) and the new rows k / v (B, n, Hkv, hd),
    causally; -> (B, n, Hq, hd) float32.  In blocks of sequences."""
    b, n, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    p = k_pre.shape[1]
    mask = torch.ones((n, p + n), dtype=torch.bool, device=q.device)
    mask[:, p:] = torch.tril(mask[:, p:])
    out = torch.empty_like(q)
    for lo in range(0, b, block):
        sl = slice(lo, lo + block)
        kk = torch.cat([k_pre[sl].to(torch.float32), k[sl]], 1)
        vv = torch.cat([v_pre[sl].to(torch.float32), v[sl]], 1)
        qq = q[sl].reshape(-1, n, hkv, g, hd)
        s = torch.einsum("bqjgd,bkjd->bjgqk", qq, kk) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf"))
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bjgqk,bkjd->bqjgd", a, vv)
        out[sl] = o.reshape(-1, n, hq, hd)
    return out


def capacity(cfg: dict, tokens: int) -> int:
    return max(int((tokens * cfg["top_k"] / cfg["n_experts"])
                   * cfg["capacity_factor"] + 0.999), 1)


def moe(cfg: dict, w: dict, x, control: bool):
    """x (B, n, D): each of the n positions is one decode step whose batch
    is the B sequences.  -> (B, n, D)."""
    b, n, d = x.shape
    e, k = cfg["n_experts"], cfg["top_k"]
    cap = capacity(cfg, b)
    xs = x.transpose(0, 1)                                  # (n, B, D)
    probs = torch.softmax(linear(xs, w["router"], control), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = srt.values[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    eidx = srt.indices[..., :k]                             # (n, B, k)
    pairs = eidx.reshape(n, b * k)
    onehot = F.one_hot(pairs, e)
    rank = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)   # (n, B*k)
    keep = (rank < cap).reshape(n, b, k)
    y = torch.zeros((n, b, d), dtype=torch.float32, device=x.device)
    flat_x = xs.reshape(n * b, d)
    for ex in range(e):
        sel = (eidx == ex) & keep                           # (n, B, k)
        tok = sel.any(-1).reshape(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        gate = (gates * sel).sum(-1).reshape(-1)[tok]
        h = flat_x[tok]
        h1 = linear(h, w["w1"][ex], control)
        h3 = linear(h, w["w3"][ex], control)
        out = linear(F.silu(h1) * h3, w["w2"][ex], control)
        y.view(n * b, d).index_add_(0, tok, out * gate[:, None])
    return y.transpose(0, 1)


def mlp(w: dict, x, control: bool):
    return linear(F.silu(linear(x, w["w1"], control))
                  * linear(x, w["w3"], control), w["w2"], control)


def forward(cfg: dict, weights: dict, prefix, tokens, start: int, *,
            control: bool = False, on_layer=None):
    """tokens (B, n) at positions start .. start+n-1 after a cache prefix
    (`prefix(i)` -> (k, v), each (B, start, Hkv, hd), of layer i) ->
    final hidden states (B, n, D) float32.  `on_layer(i, k, v)` sees each
    layer's new cache rows (k after RoPE) in float32."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(cfg, weights, prefix, tokens, start, control,
                        on_layer)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _forward(cfg, weights, prefix, tokens, start, control, on_layer):
    b, n = tokens.shape
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    hq, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    pos = torch.arange(start, start + n, device=tokens.device)
    x = weights["embed"].to(torch.float32)[tokens]          # (B, n, D)
    every = max(cfg.get("moe_every", 1), 1)
    for i in range(cfg["n_layers"]):
        pre = f"blocks.{i}."
        w = {key[len(pre):]: t for key, t in weights.items()
             if key.startswith(pre)}
        h = rms_norm(x, w["ln1"])
        q = linear(h, w["attn.wq"], control).reshape(b, n, hq, hd)
        k = linear(h, w["attn.wk"], control).reshape(b, n, hkv, hd)
        v = linear(h, w["attn.wv"], control).reshape(b, n, hkv, hd)
        if cfg.get("qk_norm"):
            q = rms_norm(q, w["attn.q_norm"])
            k = rms_norm(k, w["attn.k_norm"])
        q = rope(q, pos, cfg["rope_theta"])
        k = rope(k, pos, cfg["rope_theta"])
        if on_layer is not None:
            on_layer(i, k, v)
        k_pre, v_pre = prefix(i)
        o = attend(q, k_pre, v_pre, k, v)
        x = x + linear(o.reshape(b, n, hq * hd), w["attn.wo"], control)
        h = rms_norm(x, w["ln2"])
        if cfg["family"] == "moe" and (i + 1) % every == 0:
            x = x + moe(cfg, {kk[4:]: t for kk, t in w.items()
                              if kk.startswith("moe.")}, h, control)
        else:
            x = x + mlp({kk[4:]: t for kk, t in w.items()
                         if kk.startswith("mlp.")}, h, control)
    return rms_norm(x, weights["final_ln"])


def _logits(h, embed, control: bool):
    return linear(h, embed.t(), control)


def logit_gaps(h, embed, served, *, block: int = 256):
    """The gap by which each served token's logit lies below the best
    logit: h (B, n, D) reference hidden states, served (B, n) -> (B, n)
    float32."""
    b, n, d = h.shape
    hf, sf = h.reshape(b * n, d), served.reshape(b * n)
    out = torch.empty(b * n, dtype=torch.float32, device=h.device)
    for lo in range(0, b * n, block):
        lg = _logits(hf[lo:lo + block], embed, False)
        out[lo:lo + block] = (lg.amax(-1) - lg.gather(
            1, sf[lo:lo + block, None])[:, 0])
    return out.reshape(b, n)


def argmax_tokens(h, embed, *, control: bool, block: int = 256):
    """The token each position's logits put first: (B, n) int64."""
    b, n, d = h.shape
    hf = h.reshape(b * n, d)
    out = torch.empty(b * n, dtype=torch.int64, device=h.device)
    for lo in range(0, b * n, block):
        out[lo:lo + block] = _logits(hf[lo:lo + block], embed,
                                     control).argmax(-1)
    return out.reshape(b, n)
