"""Shared layers of the models (port of `repro.models.layers`): RMS norm,
layer norm with bias, RoPE, sinusoidal positions, the MLP variants, the
chunked cross-entropy and the decode logits."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..runtime.sharding import matmul, replicated_like, seq_whole, whole_dim


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.to(torch.float32)).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm with bias (whisper), computed in float32 and returned in
    x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)
            + bias.to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    hd = x.shape[-1]
    freqs = replicated_like(rope_freqs(hd, theta, x.device), x)
    angles = positions[..., :, None].to(torch.float32) * freqs
    angles = angles[..., None, :]                      # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device="cpu"):
    """(seq, dim) float32: sin at the even columns, cos at the odd, as the
    reference computes them in float32."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    log_base = torch.log(torch.tensor(10000.0, device=device))
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-log_base / dim))
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def mlp_apply(p: dict, x, act: str):
    """SwiGLU (w1, w3, w2), squared-ReLU (w1, w2) or GELU (w1, w2); `p`
    holds the weights already in x's dtype.  On a mesh the sequence
    shards of a (B, S, D) x are gathered first (`matmul`)."""
    if act == "swiglu":
        h = F.silu(matmul(x, p["w1"])) * matmul(x, p["w3"])
    elif act == "relu2":
        h = torch.square(F.relu(matmul(x, p["w1"])))
    elif act == "gelu":
        h = F.gelu(matmul(x, p["w1"]), approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_act {act!r}")
    return matmul(h, p["w2"])


# each weight's logical axes, as the reference's init names them
MLP_AXES = {"w1": ("embed", "mlp"), "w2": ("mlp", "embed"),
            "w3": ("embed", "mlp")}


def mlp_init(ini, d_model: int, d_ff: int, act: str) -> dict:
    p = {"w1": ini.normal((d_model, d_ff)), "w2": ini.normal((d_ff, d_model))}
    if act == "swiglu":
        p["w3"] = ini.normal((d_model, d_ff))
    return p


def _xent_chunk(hc, yc, mc, wt):
    """One chunk's summed NLL and label count, float32."""
    logits = matmul(hc, wt.T).to(torch.float32)         # (B, c, V)
    # on a mesh: DTensor's gather along a sharded vocab masks the wrong
    # rows, so the chunk's logits are gathered whole on the vocab first
    logits = whole_dim(logits, -1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def chunked_softmax_xent(h, embed, labels, chunk: int = 512,
                         label_mask=None):
    """Mean cross-entropy with logits never held at full (B, S, V).

    h: (B, S, D) final hidden states; embed: (V, D) tied output embedding
    (cast to h's dtype here, as the reference does); labels: (B, S) int.
    Each chunk of `chunk` positions (and the trailing remainder) computes
    its logits -> logsumexp -> NLL under `checkpoint`, so its (B, c, V)
    logits are recomputed in backward and never outlive the chunk.  The
    sums run in float32 in the reference's order: chunk by chunk, then
    the remainder."""
    b, s, _ = h.shape
    h = seq_whole(h)
    chunk = min(chunk, s)
    n_chunks = s // chunk
    wt = embed.to(h.dtype)
    if label_mask is None:
        label_mask = replicated_like(torch.ones(
            labels.shape, dtype=torch.float32, device=h.device), h)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if s > n_chunks * chunk:
        bounds.append((n_chunks * chunk, s))
    tot = cnt = replicated_like(torch.zeros((), dtype=torch.float32,
                                            device=h.device), h)
    for lo, hi in bounds:
        sl = (slice(None), slice(lo, hi))
        nll, n = checkpoint(_xent_chunk, h[sl], labels[sl], label_mask[sl],
                            wt, use_reentrant=False)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def logits_last(h_last, embed):
    """(B, D) x (V, D) -> (B, V) float32 logits; `embed` already in
    h_last's dtype."""
    return (h_last @ embed.T).to(torch.float32)
