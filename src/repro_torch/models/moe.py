"""Mixture-of-Experts layer with capacity-based dispatch (port of
`repro.models.moe`).

Top-k routing -> a stable sort by expert -> a static (E, C, D) dispatch
buffer -> batched expert matmuls -> weighted combine.  The router is a
softmax (`cfg.router` "softmax": the top-k probabilities, renormalised)
or sigmoid scores whose top-k is taken after a per-expert bias is added
("sigmoid_bias", DeepSeek-V3's and Nemotron-H's: logits in float32, the
gates the chosen experts' unbiased scores, renormalised); either way the
gates are then multiplied by `cfg.routed_scale`.  Tokens beyond an
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
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch._guards import detect_fake_mode
from torch.distributed.tensor import Replicate, Shard

from .. import obs
from ..runtime.sharding import (from_local_at, is_dtensor,
                                local_shape_and_offset, mesh_group,
                                replicated, replicated_like, sum_grad,
                                sum_over, to_local_at)
from .layers import MLP_AXES, mlp_apply, mlp_init

# each weight's logical axes, as the reference's init names them
MOE_AXES = {"router": ("embed", "experts"), "bias": ("experts",),
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
    if cfg.router == "sigmoid_bias":
        p["bias"] = ini.zeros((e,))
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


def _top_k(probs, k: int, bias=None):
    """probs (T, E) -> (gates, eidx) (T, k): the k largest by falling
    probability (plus `bias` (E,), which picks the experts but is not in
    the gates), ties to the lower expert, gates normalised over the k."""
    if bias is None:
        srt = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, eidx = srt.values[:, :k], srt.indices[:, :k]
    else:
        eidx = torch.sort(probs + bias, dim=-1, descending=True,
                          stable=True).indices[:, :k]
        gates = probs.gather(1, eidx)
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), eidx


def _choose(cfg, xf, p: dict):
    """xf (T, D), the router's weights `p` (router, and bias for
    sigmoid_bias) -> (probs (T, E) float32, gates (T, k) float32, eidx
    (T, k)): the router's scores and the experts they choose."""
    if cfg.router == "sigmoid_bias":
        probs = torch.sigmoid(xf.to(torch.float32)
                              @ p["router"].to(torch.float32))
        gates, eidx = _top_k(probs, cfg.top_k,
                             p["bias"].to(torch.float32))
    elif cfg.router == "softmax":
        probs = torch.softmax((xf @ p["router"]).to(torch.float32), dim=-1)
        gates, eidx = _top_k(probs, cfg.top_k)
    else:
        raise ValueError(f"unknown router {cfg.router!r}")
    if cfg.routed_scale != 1.0:
        gates = gates * cfg.routed_scale
    return probs, gates, eidx


def moe_route(probs, k: int, cap: int) -> Routing:
    """probs (T, E) float32 -> the softmax router's routing of
    `moe_apply`."""
    return _routing(*_top_k(probs, k), cap)


def _routing(gates, eidx, cap: int) -> Routing:
    """The chosen experts `eidx` (T, k) and their `gates` -> each (token,
    choice) pair's place in its expert's rows of capacity `cap`."""
    t, k = eidx.shape
    flat_e = eidx.reshape(t * k)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    # the first sorted position of each expert is its exclusive prefix sum
    rank = (torch.arange(t * k, device=eidx.device)
            - torch.searchsorted(sorted_e, sorted_e))
    keep = rank < cap
    dest = sorted_e * cap + torch.where(keep, rank, 0)
    return Routing(eidx, gates, order, keep, dest)


def _ffn(p, cfg, buf):
    """The experts on their dispatch buffer: buf (E', C, D) against the
    weights of those E' experts -> (E', C, D)."""
    h1 = torch.bmm(buf, p["w1"])
    if cfg.mlp_act == "swiglu":
        h = F.silu(h1) * torch.bmm(buf, p["w3"])
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h1))
    else:
        h = F.gelu(h1, approximate="tanh")
    return torch.bmm(h, p["w2"])


@obs.span("moe.apply")
def moe_apply(p, cfg, x):
    """x: (B, S, D) -> (y, aux_loss); `p` holds the weights in x's
    dtype.  On a mesh (DTensor x and weights): `_moe_on_mesh`."""
    if is_dtensor(x):
        return _moe_on_mesh(p, cfg, x)
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    xf = x.reshape(t, d)
    with obs.span("moe.route"):
        probs, gates, eidx = _choose(cfg, xf, p)
        r = _routing(gates, eidx, cap)

        # Switch-style load-balancing loss
        first = torch.zeros(e, dtype=torch.float32, device=x.device)
        first.index_add_(0, r.eidx[:, 0], torch.ones(t, device=x.device))
        aux = e * torch.sum(first / t * probs.mean(0))

    spare = e * cap
    with obs.span("moe.dispatch"):
        buf = x.new_zeros((spare + 1, d))
        # row i * k + c of the repeat is token i's c-th choice, so this
        # is xf[order // k] through a permutation: its gradient sums each
        # token's k rows in a fixed order (a gather of repeated rows would
        # scatter-add them, in no fixed order on several threads)
        buf[torch.where(r.keep, r.dest, spare)] = \
            xf.repeat_interleave(k, dim=0)[r.order]
    with obs.span("moe.experts"):
        out = _ffn(p, cfg, buf[:spare].reshape(e, cap, d)).reshape(spare, d)

    with obs.span("moe.combine"):
        g_sorted = r.gates.reshape(t * k)[r.order]
        contrib = out[r.dest] * (g_sorted * r.keep)[:, None].to(x.dtype)
        by_token = torch.empty_like(contrib).index_copy_(0, r.order,
                                                         contrib)
        y = by_token.reshape(t, k, d).sum(1)
    if cfg.shared_expert_ff:
        y = y + mlp_apply(p["shared"], xf, cfg.mlp_act)
    return y.reshape(b, s, d), aux


# ------------------------------------------------------------ on a mesh
def _size(mesh, dims) -> int:
    n = 1
    for i in dims:
        n *= mesh.size(i)
    return n


def _coord(mesh, dims) -> int:
    """This rank's index among the ranks of the mesh dims `dims`, the
    first dim outermost (as DTensor nests a dim's shards)."""
    c = 0
    for i in dims:
        c = c * mesh.size(i) + mesh.get_local_rank(i)
    return c


def _flat_rank(mesh, dims, chunk):
    """The contribution to a rank's row-major index in the mesh of being
    at index `chunk` (a tensor) among the ranks of the mesh dims `dims`."""
    strides = [1] * mesh.ndim
    for i in range(mesh.ndim - 2, -1, -1):
        strides[i] = strides[i + 1] * mesh.size(i + 1)
    out = torch.zeros_like(chunk)
    for i in reversed(dims):
        out = out + (chunk % mesh.size(i)) * strides[i]
        chunk = chunk // mesh.size(i)
    return out


def _all_gather(row, mesh, dims):
    """`row` of every rank of the mesh dims `dims`, stacked (ranks)."""
    out = row[None]
    for i in dims:
        out = funcol.wait_tensor(funcol.all_gather_tensor(
            out, 0, mesh.get_group(i)))
    return out


def _queue_places(eidx, mesh, dims, block, shape, e: int):
    """Each local (token, choice) pair's place in its expert's queue over
    the global batch, (L, k): the pairs before it in the global (token,
    choice) order with the same expert.  `block` = (b0, s0, bl, sl), this
    rank's rectangle of the (B, S) tokens; every rank of the mesh dims
    `dims` (those that split the tokens) adds its per-row expert counts
    to a table of the global grid of blocks, whose exclusive prefix sum
    in token order gives each local row's base."""
    b0, s0, bl, sl = block
    bsz, s = shape
    k = eidx.shape[1]
    pairs = eidx.reshape(bl, sl * k)
    onehot = F.one_hot(pairs, e)                          # (bl, sl*k, E)
    within = (onehot.cumsum(1) - onehot).gather(2, pairs[..., None])
    head = torch.tensor([b0, s0], device=eidx.device)
    rows = _all_gather(torch.cat([head, onehot.sum(1).reshape(-1)]), mesh,
                       dims)
    ns = s // sl
    table = torch.zeros((bsz, ns, e), dtype=torch.int64, device=eidx.device)
    r = rows[:, :1] + torch.arange(bl, device=eidx.device)[None, :]
    table[r, (rows[:, 1:2] // sl).expand_as(r)] = rows[:, 2:].reshape(
        -1, bl, e)
    flat = table.reshape(bsz * ns, e)
    base = (flat.cumsum(0) - flat).reshape(bsz, ns, e)[b0:b0 + bl, s0 // sl]
    return (base.gather(1, pairs) + within[..., 0]).reshape(bl * sl, k)


def _moe_on_mesh(p, cfg, x):
    """`moe_apply` on a mesh, with the experts' rows sent to their ranks.
    The (expert, capacity row) grid is split over the ranks: the experts
    over the mesh dims that shard the experts' weights on their first dim
    (each rank gathers only its own experts' slice over the other dims),
    the capacity rows over the other mesh dims.  Each rank routes its own
    tokens; an all-gather of the per-row expert counts gives each
    (token, choice) pair its place in its expert's queue over the global
    batch, exactly as `moe_route` orders them, so the same pairs are kept;
    the kept pairs' rows go to the ranks that hold their (expert, row)
    by an all-to-all, run through the experts there and come back the
    same way to be weighted and summed by token.  Ranks that hold the
    same tokens (x replicated on a mesh dim) route them alike and split
    the dispatch between them, and the parts are summed.  What a rank
    holds whole but uses a part of (the router over the token shards; the
    tokens and gates over the ranks that share them; its experts' weights
    over the row dims) has its gradient summed over the ranks that share
    it.  The shared expert runs as a dense MLP on x."""
    mesh = x.device_mesh
    bsz, s, d = x.shape
    t, e, k = bsz * s, cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    # the tokens' layout: x's shards of B and S (D whole)
    x_at = tuple(pl if isinstance(pl, Shard) and pl.dim < 2 else Replicate()
                 for pl in x.placements)
    ep_at = tuple(pl if isinstance(pl, Shard) and pl.dim == 0
                  else Replicate() for pl in p["w1"].placements)
    big = [i for i in range(mesh.ndim) if mesh.size(i) > 1]
    ep = [i for i in big if isinstance(ep_at[i], Shard)]
    split = [i for i in big if i not in ep]
    tok = [i for i in big if isinstance(x_at[i], Shard)]
    rep = [i for i in big if i not in tok]
    w = {n: sum_grad(to_local_at(p[n], ep_at), mesh, split)
         for n in ("w1", "w2", "w3") if n in p}
    ne = w["w1"].shape[0]
    e0 = local_shape_and_offset(p["w1"].shape, mesh, ep_at)[1][0]
    nc = -(-cap // _size(mesh, split))
    c0 = _coord(mesh, split) * nc

    # route this rank's tokens
    xl = to_local_at(x, x_at)
    bl, sl = xl.shape[:2]
    b0, s0 = local_shape_and_offset(x.shape, mesh, x_at)[1][:2]
    n_tok = bl * sl
    xf = xl.reshape(n_tok, d)
    rp = {n: sum_grad(to_local_at(p[n], replicated(p[n])), mesh, tok)
          for n in ("router", "bias") if n in p}
    probs, gates, eidx = _choose(cfg, xf, rp)
    first = torch.zeros(e, dtype=torch.float32, device=x.device)
    first.index_add_(0, eidx[:, 0], torch.ones(n_tok, device=x.device))
    aux = e * torch.sum(sum_over(first, mesh, tok) / t
                        * (sum_over(probs.sum(0), mesh, tok) / t))
    with torch.no_grad():
        place = _queue_places(eidx, mesh, tok, (b0, s0, bl, sl), (bsz, s), e)

    # this rank's share of the pairs of its tokens, kept and sent
    per = -(-n_tok // _size(mesh, rep))
    lo = min(n_tok, _coord(mesh, rep) * per)
    hi = min(n_tok, lo + per)
    pe, pq = eidx[lo:hi].reshape(-1), place[lo:hi].reshape(-1)
    group = mesh_group(mesh)
    n_ranks = mesh.size()
    if detect_fake_mode() is None:
        kept = torch.nonzero(pq < cap)[:, 0]
        dest = (_flat_rank(mesh, ep, pe[kept] // ne)
                + _flat_rank(mesh, split, pq[kept] // nc))
        srt = torch.sort(dest, stable=True)
        pair = kept[srt.indices]
        send = torch.bincount(srt.values, minlength=n_ranks)
        recv = funcol.wait_tensor(funcol.all_to_all_single(send, None, None,
                                                           group))
        send, recv = send.tolist(), recv.tolist()
    else:
        # a dry run on fake tensors has no routing to count: every
        # (expert, capacity row) cell is taken as full, the static E x C
        # buffer the reference's dispatch moves whatever the routing; this
        # rank's ne x nc cells come from, and go back to, every rank alike
        base, extra = divmod(ne * nc, n_ranks)
        send = recv = [base + (j < extra) for j in range(n_ranks)]
        pair = torch.zeros(ne * nc, dtype=torch.int64, device=x.device)
    # as in `moe_apply`: a permutation of the repeat, whose gradient sums
    # each token's k rows in a fixed order
    rows = sum_grad(xf, mesh, rep)[lo:hi].repeat_interleave(k, dim=0)[pair]
    got = funcol.wait_tensor(funcol.all_to_all_single_autograd(
        rows, recv, send, group))
    meta = funcol.wait_tensor(funcol.all_to_all_single(
        torch.stack([pe[pair], pq[pair]], 1), recv, send, group))
    slot = (meta[:, 0] - e0) * nc + (meta[:, 1] - c0)
    buf = got.new_zeros((ne * nc, d))
    buf[slot] = got
    out = _ffn(w, cfg, buf.reshape(ne, nc, d)).reshape(ne * nc, d)
    back = funcol.wait_tensor(funcol.all_to_all_single_autograd(
        out[slot], send, recv, group))

    # weight each pair's row by its gate and sum by token, choices in order
    g = sum_grad(gates, mesh, rep)[lo:hi].reshape(-1)[pair]
    contrib = back * g[:, None].to(back.dtype)
    by_pair = contrib.new_zeros(((hi - lo) * k, d)).index_copy(0, pair,
                                                                contrib)
    y = by_pair.reshape(hi - lo, k, d).sum(1)
    y = torch.cat([y.new_zeros((lo, d)), y,
                   y.new_zeros((n_tok - hi, d))])
    y = from_local_at(sum_over(y, mesh, rep).reshape(bl, sl, d), x, x_at)
    if cfg.shared_expert_ff:
        y = y + mlp_apply(p["shared"], x, cfg.mlp_act)
    return y, replicated_like(aux, x)
