"""Shared layers of the decoder (port of `repro.models.layers`): RMS
norm, RoPE, the MLP variants and the decode logits."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    angles = angles[..., None, :]                      # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p: dict, x, act: str):
    """SwiGLU (w1, w3, w2), squared-ReLU (w1, w2) or GELU (w1, w2); `p`
    holds the weights already in x's dtype."""
    if act == "swiglu":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    elif act == "relu2":
        h = torch.square(F.relu(x @ p["w1"]))
    elif act == "gelu":
        h = F.gelu(x @ p["w1"], approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_act {act!r}")
    return h @ p["w2"]


def mlp_init(ini, d_model: int, d_ff: int, act: str) -> dict:
    p = {"w1": ini.normal((d_model, d_ff)), "w2": ini.normal((d_ff, d_model))}
    if act == "swiglu":
        p["w3"] = ini.normal((d_model, d_ff))
    return p


def logits_last(h_last, embed):
    """(B, D) x (V, D) -> (B, V) float32 logits; `embed` already in
    h_last's dtype."""
    return (h_last @ embed.T).to(torch.float32)
