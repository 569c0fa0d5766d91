"""Mixture-of-Experts layer with capacity-based dispatch (port of
`repro.models.moe`).

Top-k routing -> a stable sort by expert -> a static (E, C, D) dispatch
buffer -> batched expert matmuls -> weighted combine.  Tokens beyond an
expert's capacity C = int(T * k / E * capacity_factor + 0.999) lose that
expert's contribution, as in the reference: at decode T is the batch, so
olmoe-1b-7b at batch 4 has C = 1 and two tokens that pick one expert in a
step keep only the first one's.

Every step is deterministic on the card, backward included: the top-k
breaks ties by the lower expert index (as `jax.lax.top_k` does;
`torch.topk` promises no order for ties), the dispatch writes each kept
row once (dropped rows go to a spare row that is cut off), and the
combine gathers each token's k contributions and sums them (the
reference's scatter-add would be an atomic `index_add_`, summed in no
fixed order).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import MLP_AXES, mlp_apply, mlp_init

# each weight's logical axes, as the reference's init names them
MOE_AXES = {"router": ("embed", "experts"),
            "w1": ("experts", "embed", "mlp"),
            "w2": ("experts", "mlp", "embed"),
            "w3": ("experts", "embed", "mlp"),
            **{f"shared.{k}": v for k, v in MLP_AXES.items()}}


def moe_init(ini, cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": ini.normal((d, e), scale=0.02),
         "w1": ini.normal((e, d, f)), "w2": ini.normal((e, f, d))}
    if cfg.mlp_act == "swiglu":
        p["w3"] = ini.normal((e, d, f))
    if cfg.shared_expert_ff:
        p.update({f"shared.{k}": v for k, v in mlp_init(
            ini, d, cfg.shared_expert_ff, cfg.mlp_act).items()})
    return p


def capacity(cfg, tokens: int) -> int:
    """Rows each expert takes, in the reference's Python float
    arithmetic (not math.ceil)."""
    cap = int((tokens * cfg.top_k / cfg.n_experts) * cfg.capacity_factor
              + 0.999)
    return max(cap, 1)


class Routing(NamedTuple):
    eidx: torch.Tensor    # (T, k) chosen experts, by falling probability
    gates: torch.Tensor   # (T, k) float32, normalised over the k
    order: torch.Tensor   # (T*k,) the (token, choice) pairs sorted by expert
    keep: torch.Tensor    # (T*k,) bool, in sorted order: within capacity
    dest: torch.Tensor    # (T*k,) dispatch row e * cap + rank (0 if dropped)


def moe_route(probs, k: int, cap: int) -> Routing:
    """probs (T, E) float32 -> the routing of `moe_apply`."""
    t, _ = probs.shape
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = srt.values[:, :k], srt.indices[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = eidx.reshape(t * k)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # the first sorted position of each expert is its exclusive prefix sum
    rank = (torch.arange(t * k, device=probs.device)
            - torch.searchsorted(sorted_e, sorted_e))
    keep = rank < cap
    dest = sorted_e * cap + torch.where(keep, rank, 0)
    return Routing(eidx, gates, order, keep, dest)


def moe_apply(p, cfg, x):
    """x: (B, S, D) -> (y, aux_loss); `p` holds the weights in x's
    dtype."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    xf = x.reshape(t, d)
    logits = (xf @ p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    r = moe_route(probs, k, cap)

    # Switch-style load-balancing loss
    first = torch.zeros(e, dtype=torch.float32, device=x.device)
    first.index_add_(0, r.eidx[:, 0], torch.ones(t, device=x.device))
    aux = e * torch.sum(first / t * probs.mean(0))

    spare = e * cap
    buf = x.new_zeros((spare + 1, d))
    # row i * k + c of the repeat is token i's c-th choice, so this is
    # xf[order // k] through a permutation: its gradient sums each
    # token's k rows in a fixed order (a gather of repeated rows would
    # scatter-add them, in no fixed order on several threads)
    buf[torch.where(r.keep, r.dest, spare)] = \
        xf.repeat_interleave(k, dim=0)[r.order]
    buf = buf[:spare].reshape(e, cap, d)
    h1 = torch.bmm(buf, p["w1"])
    if cfg.mlp_act == "swiglu":
        h = F.silu(h1) * torch.bmm(buf, p["w3"])
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h1))
    else:
        h = F.gelu(h1, approximate="tanh")
    out = torch.bmm(h, p["w2"]).reshape(spare, d)

    g_sorted = r.gates.reshape(t * k)[r.order]
    contrib = out[r.dest] * (g_sorted * r.keep)[:, None].to(x.dtype)
    by_token = torch.empty_like(contrib).index_copy_(0, r.order, contrib)
    y = by_token.reshape(t, k, d).sum(1)
    if cfg.shared_expert_ff:
        y = y + mlp_apply(p["shared"], xf, cfg.mlp_act)
    return y.reshape(b, s, d), aux
