"""Mamba2 (SSD) block, the recurrent decode step (port of the decode side
of `repro.models.ssm`; its chunked `ssm_apply` comes with the training
path).

The state h (B, H, N, P) is float32; the projections and the causal conv
run in the compute dtype.  The conv states are stored in float32 and read
back in the compute dtype: the values written are compute-dtype values,
which float32 holds exactly, so the round trip is the reference's.  dt's
softplus is `logaddexp(dt, 0)`, the formula of `jax.nn.softplus`
(max(x, 0) + log1p(exp(-|x|))); `F.softplus` switches to the identity
above 20, which differs from it by under 2.1e-9, below float32's
resolution there, but is not the same code path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rms_norm


def ssm_init(ini, cfg) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    h, n, g, k = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_conv
    return {
        "wz": ini.normal((d, din)),
        "wx": ini.normal((d, din)),
        "wB": ini.normal((d, g * n)),
        "wC": ini.normal((d, g * n)),
        "wdt": ini.normal((d, h)),
        "conv_x": ini.normal((k, din), scale=0.5),
        "conv_B": ini.normal((k, g * n), scale=0.5),
        "conv_C": ini.normal((k, g * n), scale=0.5),
        "A_log": ini.zeros((h,)),
        "D": ini.ones((h,)),
        "dt_bias": ini.const((h,), -2.0),
        "norm": ini.ones((din,)),
        "out": ini.normal((din, d)),
    }


def _causal_conv(x, w, state):
    """Depthwise causal conv.  x: (B, S, C) compute dtype; w: (K, C) in
    x's dtype; state: (B, K-1, C) trailing context, overwritten in place
    with the new context.  Returns y (B, S, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    if k > 1:
        state.copy_(xp[:, -(k - 1):])
    return y


def _project(p, cfg, x):
    z = x @ p["wz"]
    xin = x @ p["wx"]
    b_ = x @ p["wB"]
    c_ = x @ p["wC"]
    dt = (x @ p["wdt"]).to(torch.float32) + p["dt_bias"].to(torch.float32)
    dt = torch.logaddexp(dt, dt.new_zeros(()))
    return z, xin, b_, c_, dt


def ssm_init_cache(cfg, batch: int, device, lead=()) -> dict:
    """Decode state of one block (or of `lead` stacked blocks): the three
    conv contexts and h, all float32."""
    h, n, p, k = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim, cfg.ssm_conv
    gn = cfg.ssm_ngroups * n

    def zeros(*shape):
        return torch.zeros((*lead, batch, *shape), dtype=torch.float32,
                           device=device)

    return {"conv_x": zeros(k - 1, cfg.d_inner), "conv_B": zeros(k - 1, gn),
            "conv_C": zeros(k - 1, gn), "h": zeros(h, n, p)}


def ssm_decode_step(p, cfg, x, cache):
    """Recurrent step.  x: (B, 1, D) -> y (B, 1, D); `p` holds the
    projections and conv weights in x's dtype; `cache` (conv_x, conv_B,
    conv_C, h) is updated in place."""
    bsz = x.shape[0]
    nh, n, g, hp = (cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups,
                    cfg.ssm_headdim)
    hpg = nh // g
    z, xin, b_, c_, dt = _project(p, cfg, x)
    xin = F.silu(_causal_conv(xin, p["conv_x"], cache["conv_x"]))
    b_ = F.silu(_causal_conv(b_, p["conv_B"], cache["conv_B"]))
    c_ = F.silu(_causal_conv(c_, p["conv_C"], cache["conv_C"]))

    a_neg = -torch.exp(p["A_log"].to(torch.float32))
    dt1 = dt[:, 0]                                          # (B, H)
    decay = torch.exp(dt1 * a_neg)
    xh = xin.reshape(bsz, nh, hp).to(torch.float32)
    bh = torch.repeat_interleave(b_.reshape(bsz, g, n), hpg, dim=1)
    ch = torch.repeat_interleave(c_.reshape(bsz, g, n), hpg, dim=1)
    h = (cache["h"] * decay[..., None, None]
         + (bh * dt1[..., None])[..., :, None] * xh[..., None, :])
    cache["h"].copy_(h)
    y = torch.einsum("bhn,bhnp->bhp", ch.to(torch.float32), h)
    y = y + xh * p["D"].to(torch.float32)[:, None]
    y = y.reshape(bsz, 1, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out"]
