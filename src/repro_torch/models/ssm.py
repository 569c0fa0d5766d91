"""Mamba2 (SSD) block (port of `repro.models.ssm`): the chunked SSD
forward over a whole sequence (training and prefill) and the recurrent
decode step.

Within a chunk of c tokens the output is a masked (c x c) product (the
attention-like dual form); across chunks the state h (B, H, N, P) is
carried by a Python loop (the reference's `lax.scan`).

The state h (B, H, N, P) is float32; the projections and the causal conv
run in the compute dtype.  The conv states are stored in float32 and read
back in the compute dtype: the values written are compute-dtype values,
which float32 holds exactly, so the round trip is the reference's.  dt's
softplus is `logaddexp(dt, 0)`, the formula of `jax.nn.softplus`
(max(x, 0) + log1p(exp(-|x|))); `F.softplus` switches to the identity
above 20, which differs from it by under 2.1e-9, below float32's
resolution there, but is not the same code path.

Where the config asks, the depthwise conv adds a bias (`ssm_conv_bias`)
and the gated RMS norm is taken over each of `ssm_norm_groups` equal
groups of d_inner (Mamba-2's grouped norm; one group is the whole
width).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from .. import obs
from ..runtime.sharding import (batch_only, is_dtensor, replicated,
                                sum_grad, sum_over, sum_to, to_local_at,
                                unpartial)
from .layers import rms_norm


# each parameter's logical axes, as the reference's init names them
SSM_AXES = {"wz": ("embed", "mlp"), "wx": ("embed", "mlp"),
            "wB": ("embed", None), "wC": ("embed", None),
            "wdt": ("embed", None), "conv_x": (None, "mlp"),
            "conv_B": (None, None), "conv_C": (None, None),
            "A_log": (None,), "D": (None,), "dt_bias": (None,),
            "norm": ("mlp",), "out": ("mlp", "embed"),
            "conv_x_bias": ("mlp",), "conv_B_bias": (None,),
            "conv_C_bias": (None,)}


def ssm_init(ini, cfg) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    h, n, g, k = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_conv
    p = {
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
    if cfg.ssm_conv_bias:
        p.update(conv_x_bias=ini.zeros((din,)),
                 conv_B_bias=ini.zeros((g * n,)),
                 conv_C_bias=ini.zeros((g * n,)))
    return p


def _causal_conv(x, w, state=None, bias=None):
    """Depthwise causal conv.  x: (B, S, C) compute dtype; w: (K, C) in
    x's dtype; state: (B, K-1, C) trailing context (decode), overwritten
    in place with the new context, or None: zeros before the sequence;
    bias: (C,) in x's dtype, or None.  Returns y (B, S, C)."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    if bias is not None:
        y = y + bias
    if state is not None and k > 1:
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


def _dims(p, cfg) -> tuple:
    """(heads, groups, d_inner) of the weights `p` holds: all of them, or
    one rank's share on a mesh (`_local_weights`)."""
    return (p["A_log"].shape[0], p["wB"].shape[1] // cfg.ssm_state,
            p["wx"].shape[1])


def _ssd(p, cfg, x):
    """The chunked SSD of `ssm_apply` up to the gate: x (B, S, D) -> the
    gated output (B, S, d_inner) in x's dtype, before the norm."""
    bsz, s, _ = x.shape
    nh, g, din = _dims(p, cfg)
    n, hp = cfg.ssm_state, cfg.ssm_headdim
    c = min(cfg.ssm_chunk, s)
    assert s % c == 0, (s, c)
    nc, hpg = s // c, nh // g
    f32 = torch.float32
    z, xin, b_, c_, dt = _project(p, cfg, x)
    xin = F.silu(_causal_conv(xin, p["conv_x"], None, p.get("conv_x_bias")))
    b_ = F.silu(_causal_conv(b_, p["conv_B"], None, p.get("conv_B_bias")))
    c_ = F.silu(_causal_conv(c_, p["conv_C"], None, p.get("conv_C_bias")))

    a_neg = -torch.exp(p["A_log"].to(f32))                  # (H,)
    xh = xin.reshape(bsz, nc, c, nh, hp).to(f32)
    bh = b_.reshape(bsz, nc, c, g, n).to(f32)
    ch = c_.reshape(bsz, nc, c, g, n).to(f32)
    dts = dt.reshape(bsz, nc, c, nh)
    cum = torch.cumsum(dts * a_neg, dim=2)                  # within-chunk
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))
    h = x.new_zeros((bsz, nh, n, hp), dtype=f32)
    ys = []
    for i in range(nc):
        xc, bc, cc = xh[:, i], bh[:, i], ch[:, i]
        cumc, dtc = cum[:, i], dts[:, i]
        # intra-chunk: w[i,j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, i >= j
        cb = torch.repeat_interleave(
            torch.einsum("bign,bjgn->bijg", cc, bc), hpg, dim=-1)
        decay = torch.exp(cumc[:, :, None, :] - cumc[:, None, :, :])
        w = torch.where(mask[None, :, :, None], cb * decay, 0.0)
        y_intra = torch.einsum("bijh,bjhp->bihp", w * dtc[:, None, :, :],
                               xc)
        # inter-chunk: the carried state's contribution
        c_heads = torch.repeat_interleave(cc, hpg, dim=2)  # (B, c, H, N)
        y_inter = (torch.einsum("bchn,bhnp->bchp", c_heads, h)
                   * torch.exp(cumc)[..., None])
        # h' = exp(sum a) h + sum_j exp(cum_last - cum_j) dt_j B_j x_j
        tail = torch.exp(cumc[:, -1:, :] - cumc)            # (B, c, H)
        b_heads = torch.repeat_interleave(bc, hpg, dim=2)
        dstate = torch.einsum("bchn,bchp->bhnp",
                              b_heads * (tail * dtc)[..., None], xc)
        h = h * torch.exp(cumc[:, -1, :])[..., None, None] + dstate
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, s, nh, hp)
    y = y + xh.reshape(bsz, s, nh, hp) * p["D"].to(f32)[:, None]
    y = y.reshape(bsz, s, din).to(x.dtype)
    return y * F.silu(z)


def ssm_apply(p, cfg, x):
    """Chunked SSD forward.  x: (B, S, D) -> (B, S, D); `p` holds the
    projections and conv weights in x's dtype.  S must be a multiple of
    the chunk min(ssm_chunk, S).  On a mesh (DTensor x and weights):
    `_on_mesh`."""
    if is_dtensor(x):
        return _on_mesh(p, cfg, x, None)
    return _gated_norm(_ssd(p, cfg, x), p["norm"], cfg.ssm_norm_groups,
                       cfg.norm_eps) @ p["out"]


def _gated_norm(v, w, groups: int, eps: float = 1e-6):
    """The RMS norm of the gated output v (..., d_inner), over each of
    `groups` equal groups of its last dim; w (d_inner,)."""
    if groups == 1:
        return rms_norm(v, w, eps)
    shape = v.shape
    return rms_norm(v.reshape(*shape[:-1], groups, shape[-1] // groups),
                    w.reshape(groups, -1), eps).reshape(shape)


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


def _decode(p, cfg, x, cache):
    """The recurrent step of `ssm_decode_step` up to the gate: x (B, 1, D)
    -> the gated output (B, 1, d_inner); `cache` updated in place."""
    bsz = x.shape[0]
    nh, g, din = _dims(p, cfg)
    n, hp = cfg.ssm_state, cfg.ssm_headdim
    hpg = nh // g
    z, xin, b_, c_, dt = _project(p, cfg, x)
    xin = F.silu(_causal_conv(xin, p["conv_x"], cache["conv_x"],
                              p.get("conv_x_bias")))
    b_ = F.silu(_causal_conv(b_, p["conv_B"], cache["conv_B"],
                             p.get("conv_B_bias")))
    c_ = F.silu(_causal_conv(c_, p["conv_C"], cache["conv_C"],
                             p.get("conv_C_bias")))

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
    y = y.reshape(bsz, 1, din).to(x.dtype)
    return y * F.silu(z)


def ssm_decode_step(p, cfg, x, cache):
    """Recurrent step.  x: (B, 1, D) -> y (B, 1, D); `p` holds the
    projections and conv weights in x's dtype; `cache` (conv_x, conv_B,
    conv_C, h) is updated in place (on a mesh: DTensor leaves, each rank
    writing its shard)."""
    if is_dtensor(x):
        return _on_mesh(p, cfg, x, cache)
    with obs.span("ssm.decode"):
        return _gated_norm(_decode(p, cfg, x, cache), p["norm"],
                           cfg.ssm_norm_groups, cfg.norm_eps) @ p["out"]


# on a mesh: the dim of each weight and decode-state leaf that runs along
# the heads (d_inner or H), and along the groups of B and C
_HEAD_DIM = {"wz": 1, "wx": 1, "wdt": 1, "conv_x": 1, "A_log": 0, "D": 0,
             "dt_bias": 0, "norm": 0, "out": 0}
_GROUP_DIM = {"wB": 1, "wC": 1, "conv_B": 1, "conv_C": 1}
_STATE_HEAD_DIM = {"conv_x": 2, "h": 1}
_STATE_GROUP_DIM = {"conv_B": 2, "conv_C": 2}


def _on_mesh(p, cfg, x, cache):
    """`ssm_apply` (cache None) or `ssm_decode_step` on a mesh.  The heads
    are split over the mesh dims that shard d_inner (the "mlp" axis of
    wx) when the heads divide them evenly (and the groups of B and C too,
    or there is one group): each rank gathers its heads' slice of every
    weight (and the groups' weights whole when there is one group), runs
    its heads on the tokens of its batch shard, and the ranks' parts of
    the output are summed straight to x's placements (a reduce-scatter
    over the sequence shards), the gated norm's sum of squares first.
    What a rank holds whole but uses a part of (the tokens, the one
    group's weights) has its gradient summed over the ranks that split
    the heads.  Otherwise every rank runs all heads.  The decode state is
    read and written at the same split, each rank writing its shard back
    into the cache through `to_local()`."""
    if cfg.ssm_norm_groups > 1 or cfg.ssm_conv_bias:
        raise NotImplementedError("a grouped gated norm or a conv bias on "
                                  "a mesh")
    mesh = x.device_mesh
    bat = batch_only(x if cache is None else cache["h"])
    nh, g = cfg.ssm_heads, cfg.ssm_ngroups
    tp = [i for i, pl in enumerate(p["wx"].placements)
          if isinstance(pl, Shard) and pl.dim == 1 and mesh.size(i) > 1
          and not isinstance(bat[i], Shard)]
    n = 1
    for i in tp:
        n *= mesh.size(i)
    if nh % n or (g > 1 and g % n):
        tp, n = [], 1

    def at(dim, base):
        return tuple(Shard(dim) if i in tp and dim is not None else base[i]
                     for i in range(mesh.ndim))

    rep = replicated(x)
    local = {}
    for k, w in p.items():
        dim = _HEAD_DIM.get(k, _GROUP_DIM.get(k) if g > 1 else None)
        wl = to_local_at(w, at(dim, rep))
        local[k] = wl if dim is not None else sum_grad(wl, mesh, tp)
    xl = sum_grad(to_local_at(x, bat), mesh, tp)
    if cache is None:
        v = _ssd(local, cfg, xl)
    else:
        state_at = {k: at(_STATE_HEAD_DIM.get(
            k, _STATE_GROUP_DIM.get(k) if g > 1 else None), bat)
            for k in cache}
        state = {k: to_local_at(c, state_at[k]).clone()
                 for k, c in cache.items()}
        v = _decode(local, cfg, xl, state)
        for k, c in cache.items():
            new = DTensor.from_local(state[k], mesh, state_at[k],
                                     run_check=False, shape=c.shape,
                                     stride=c.stride())
            c.to_local().copy_(new.redistribute(mesh,
                                                c.placements).to_local())
    if tp:
        v = _rms_norm_split(v, local["norm"], mesh, tp, cfg.d_inner,
                             cfg.norm_eps)
    else:
        v = rms_norm(v, local["norm"], cfg.norm_eps)
    return sum_to(v @ local["out"], x, tp, bat, unpartial(x))


def _rms_norm_split(v, w, mesh, dims, width: int, eps: float = 1e-6):
    """`rms_norm` over a last dim of `width` split over the mesh dims
    `dims`: v and w hold this rank's part."""
    dt = v.dtype
    v = v.to(torch.float32)
    ss = sum_grad(sum_over((v * v).sum(-1, keepdim=True), mesh, dims), mesh,
                  dims)
    v = v * torch.rsqrt(ss / width + eps)
    return (v * w.to(torch.float32)).to(dt)
