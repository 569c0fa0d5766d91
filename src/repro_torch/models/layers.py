"""Shared layers of the models (port of `repro.models.layers`): RMS norm,
layer norm with bias, RoPE, sinusoidal positions, the MLP variants, the
chunked cross-entropy and the decode logits."""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..runtime.sharding import (from_local_at, is_dtensor,
                                local_shape_and_offset, matmul,
                                replicated, replicated_like, sum_over,
                                target_placements, to_local_at)


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


def _xent_chunk(hc, yc, mc, wt, mesh=None, vocab=(), v0=0):
    """One chunk's summed NLL and label count, float32: hc (b, c, D)
    against wt (v, D), the columns of the vocab from `v0`.  On a mesh
    these are this rank's shards (`_on_shards`) and the vocab's mesh dims
    `vocab` give the logsumexp an all-reduce max and an all-reduce sum;
    the label's logit is taken on the rank whose columns hold it (0
    elsewhere) and summed over them.  Without vocab dims:
    `torch.logsumexp` and `torch.gather`, as the unsharded step computes
    them."""
    logits = (hc @ wt.T).to(torch.float32)              # (b, c, v)
    if vocab:
        with torch.no_grad():
            m = logits.amax(dim=-1)
            for i in vocab:
                m = funcol.wait_tensor(funcol.all_reduce(
                    m, "max", mesh.get_group(i)))
        lse = m + torch.log(sum_over(
            torch.exp(logits - m[..., None]).sum(dim=-1), mesh, vocab))
        idx = yc.long() - v0
        mine = (idx >= 0) & (idx < logits.shape[-1])
        gold = torch.gather(logits, -1,
                            torch.where(mine, idx, 0)[..., None])[..., 0]
        gold = sum_over(torch.where(mine, gold, 0.0), mesh, vocab)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def _on_shards(h, wt, labels, label_mask):
    """The xent's operands on a mesh as this rank's local tensors: h's
    rows of the batch as the rules split it (the sequence and D whole),
    the embedding's rows of the vocab, gathered on every other mesh dim
    (FSDP's all-gather of its D shards: the batch is never gathered),
    and the labels and mask at h's rows.  Their gradients go back as
    partial sums (the embedding's over the rows' mesh dims, h's over the
    vocab's), which DTensor reduce-scatters to their shards.  Returns
    (h, wt, labels, mask, mesh, vocab dims, rows dims, the vocab
    offset)."""
    h = h.redistribute(h.device_mesh,
                       target_placements(h, ("batch", None, None)))
    mesh, hp, wp = h.device_mesh, h.placements, wt.placements
    big = [i for i in range(mesh.ndim) if mesh.size(i) > 1]
    rows = tuple(i for i in big if isinstance(hp[i], Shard))
    vocab = tuple(i for i in big if isinstance(wp[i], Shard)
                  and wp[i].dim == 0)
    if set(rows) & set(vocab):
        raise ValueError(f"xent: the batch {hp} and the vocab {wp} split "
                         "over one mesh dim")
    w_at = tuple(Shard(0) if i in vocab else Replicate()
                 for i in range(mesh.ndim))
    wl = wt.redistribute(mesh, w_at).to_local(grad_placements=tuple(
        Partial() if i in rows else p for i, p in enumerate(w_at)))
    hl = h.to_local(grad_placements=tuple(
        Partial() if i in vocab else p for i, p in enumerate(hp)))
    v0 = local_shape_and_offset(wt.shape, mesh, w_at)[1][0]
    return (hl, wl, to_local_at(labels, hp), to_local_at(label_mask, hp),
            mesh, vocab, rows, v0)


def chunked_softmax_xent(h, embed, labels, chunk: int = 512,
                         label_mask=None):
    """Mean cross-entropy with logits never held at full (B, S, V).

    h: (B, S, D) final hidden states; embed: (V, D) tied output embedding
    (cast to h's dtype here, as the reference does); labels: (B, S) int.
    Each chunk of `chunk` positions (and the trailing remainder) computes
    its logits -> logsumexp -> NLL under `checkpoint`, so its (B, c, V)
    logits are recomputed in backward and never outlive the chunk.  The
    sums run in float32 in the reference's order: chunk by chunk, then
    the remainder.  On a mesh (DTensor h and embedding) every chunk runs
    on this rank's rows of the batch and columns of the vocab
    (`_on_shards`), and the rows' sums are added over the ranks at the
    end: a rank holds (B / rows' ranks, c, V / vocab's ranks) logits."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    n_chunks = s // chunk
    wt = embed.to(h.dtype)
    if label_mask is None:
        label_mask = replicated_like(torch.ones(
            labels.shape, dtype=torch.float32, device=h.device), h)
    ref, mesh, vocab, rows, v0 = h, None, (), (), 0
    if is_dtensor(h):
        h, wt, labels, label_mask, mesh, vocab, rows, v0 = _on_shards(
            h, wt, labels, label_mask)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if s > n_chunks * chunk:
        bounds.append((n_chunks * chunk, s))
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo, hi in bounds:
        sl = (slice(None), slice(lo, hi))
        nll, n = checkpoint(_xent_chunk, h[sl], labels[sl], label_mask[sl],
                            wt, mesh, vocab, v0, use_reentrant=False)
        tot, cnt = tot + nll, cnt + n
    loss = sum_over(tot, mesh, rows) / torch.clamp(
        sum_over(cnt, mesh, rows), min=1.0)
    return from_local_at(loss, ref, replicated(ref)) if mesh else loss


def logits_last(h_last, embed):
    """(B, D) x (V, D) -> (B, V) float32 logits; `embed` already in
    h_last's dtype."""
    return (h_last @ embed.T).to(torch.float32)
