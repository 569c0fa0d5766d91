"""Blockwise attention in plain torch (port of `repro.models.attention`:
causal self-attention over a whole sequence for training and prefill,
decode self-attention against a cache, and the cross-attention).  Scores
are materialised one (q_chunk x k_chunk) block at a time with an
online-softmax (max, denom, acc) state, in the reference's order of
operations and with its -1e30 masking; GQA repeats each KV head for its
G query heads, chunk by chunk.  Under autograd each q-chunk is recomputed
in backward (the reference's `jax.checkpoint` of its q-chunk body), so
the scores of one chunk at a time are live.  Decode on the card launches
one kernel instead (`kernels/gqa_decode.py`, A1), with this chunk loop as
its plain version."""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Replicate, Shard
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..kernels import cuda_lib, gqa_decode
from ..runtime.sharding import (constrain, from_local_at, is_dtensor,
                                local_shape_and_offset, matmul,
                                replicated_like, target_placements,
                                to_local_at)
from .layers import apply_rope, rms_norm

NEG_INF = -1e30


def _block_attend(q, k, v, bias):
    """One block: q (B,H,qc,D), k/v (B,kc,H,D), bias (qc,kc).  Returns the
    online-softmax pieces m (B,H,qc), l (B,H,qc), o (B,H,qc,D) float32."""
    if q.dtype != k.dtype:      # float32 cross K/V under a bf16 config
        q = q.to(torch.promote_types(q.dtype, k.dtype))
    s = torch.einsum("bhqd,bkhd->bhqk", q, k).to(torch.float32)
    s = s + bias
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype), v)
    return m, l, o.to(torch.float32)


def _q_chunk_state(qc, kb, vb, qpos, k_pos, causal: bool, kv_length):
    """One q-chunk against every k-chunk: qc (B,Hq,qc,D) scaled, kb/vb
    (nk,B,kc,Hkv,D), qpos (qc,), k_pos (nk,kc) -> the online softmax's
    (m, l, o) float32; `_q_chunk` normalises o by l."""
    b, hq, q_chunk, d = qc.shape
    g = hq // kb.shape[3]
    dev = qc.device
    m = torch.full((b, hq, q_chunk), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hq, q_chunk), dtype=torch.float32, device=dev)
    o = torch.zeros((b, hq, q_chunk, d), dtype=torch.float32, device=dev)
    for j in range(kb.shape[0]):
        kc, vc = kb[j], vb[j]
        if g > 1:
            kc = torch.repeat_interleave(kc, g, dim=2)
            vc = torch.repeat_interleave(vc, g, dim=2)
        bias = torch.zeros((q_chunk, kb.shape[2]), dtype=torch.float32,
                           device=dev)
        if causal:
            bias = torch.where(qpos[:, None] >= k_pos[j][None, :], 0.0,
                               NEG_INF)
        if kv_length is not None:
            bias = bias + torch.where(k_pos[j][None, :] < kv_length, 0.0,
                                      NEG_INF)
        bm, bl, bo = _block_attend(qc, kc, vc, bias)
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(bm - m_new)
        l = l * alpha + bl * beta
        o = o * alpha[..., None] + bo * beta[..., None]
        m = m_new
    return m, l, o


def _q_chunk(*args):
    m, l, o = _q_chunk_state(*args)
    return o / torch.clamp(l, min=1e-30)[..., None]


def blockwise_attention(q, k, v, *, causal: bool, q_offset=0, k_offset=0,
                        q_chunk: int = 512, k_chunk: int = 1024,
                        kv_length=None):
    """q: (B,S,Hq,D), k/v: (B,T,Hkv,D) -> (B,S,Hq,D) in q's dtype.
    `kv_length` is the valid KV prefix length (decode against a
    preallocated cache).  Under autograd each q-chunk is recomputed in
    backward."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    assert hq % hkv == 0
    scale = 1.0 / (d ** 0.5)
    q_chunk, k_chunk = min(q_chunk, s), min(k_chunk, t)
    assert s % q_chunk == 0 and t % k_chunk == 0, (s, q_chunk, t, k_chunk)
    nq, nk = s // q_chunk, t // k_chunk
    dev = q.device
    qb = (q * scale).reshape(b, nq, q_chunk, hq, d).permute(1, 0, 3, 2, 4)
    kb = k.reshape(b, nk, k_chunk, hkv, d).transpose(0, 1)
    vb = v.reshape(b, nk, k_chunk, hkv, d).transpose(0, 1)
    q_pos = torch.arange(s, device=dev).reshape(nq, q_chunk) + q_offset
    k_pos = torch.arange(t, device=dev).reshape(nk, k_chunk) + k_offset
    remat = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    outs = []
    for i in range(nq):
        args = (qb[i], kb, vb, q_pos[i], k_pos, causal, kv_length)
        outs.append(checkpoint(_q_chunk, *args, use_reentrant=False)
                    if remat else _q_chunk(*args))
    out = torch.stack(outs)                     # (nq, B, Hq, qc, D)
    return out.permute(1, 0, 3, 2, 4).reshape(b, s, hq, d).to(q.dtype)


def decode_attention_state_plain(q, k_cache, v_cache, length,
                                 k_chunk: int = 2048):
    """A1's plain version: the chunk loop of `_q_chunk_state` over every
    `k_chunk` positions of the cache, masked by `length`."""
    b, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    assert hq % hkv == 0
    k_chunk = min(k_chunk, t)
    assert t % k_chunk == 0, (t, k_chunk)
    nk = t // k_chunk
    kb = k_cache.reshape(b, nk, k_chunk, hkv, d).transpose(0, 1)
    vb = v_cache.reshape(b, nk, k_chunk, hkv, d).transpose(0, 1)
    k_pos = torch.arange(t, device=q.device).reshape(nk, k_chunk)
    qc = (q * (1.0 / (d ** 0.5)))[:, :, None]              # (B,Hq,1,D)
    m, l, o = _q_chunk_state(qc, kb, vb, None, k_pos, False, length)
    return m[..., 0], l[..., 0], o[:, :, 0]


def _on_card(q) -> bool:
    """A CUDA query launches A1 (which refuses a cache elsewhere); one on
    the CPU or with no storage (a dry run's FakeTensor, a meta tensor)
    runs the plain version."""
    from torch._subclasses.fake_tensor import is_fake

    return q.device.type == "cuda" and not is_fake(q)


@cuda_lib.kernel_wrapper("gqa_decode")
def decode_attention_state(q, k_cache, v_cache, length,
                           k_chunk: int = 2048):
    """Single-token decode before the normalisation: q (B,Hq,D) against
    cache (B,T,Hkv,D) with `length` valid positions -> the online
    softmax's (m, l, o), (B,Hq) / (B,Hq) / (B,Hq,D) float32 (a decode
    whose cache is split over ranks combines them).  `k_chunk` is the
    plain version's chunk; A1 ignores it."""
    if _on_card(q):
        return gqa_decode.gqa_decode_cuda(q, k_cache, v_cache, length,
                                          state=True)
    return decode_attention_state_plain(q, k_cache, v_cache, length, k_chunk)


@obs.span("attn.decode")
@cuda_lib.kernel_wrapper("gqa_decode")
def chunked_decode_attention(q, k_cache, v_cache, length,
                             k_chunk: int = 2048):
    """Single-token decode: q (B,Hq,D) against cache (B,T,Hkv,D) with
    `length` valid positions -> (B,Hq,D) in q's dtype (on the card A1
    normalises and casts too)."""
    if _on_card(q):
        return gqa_decode.gqa_decode_cuda(q, k_cache, v_cache, length,
                                          state=False)
    m, l, o = decode_attention_state_plain(q, k_cache, v_cache, length,
                                           k_chunk)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


# each projection's logical axes, as the reference's init names them (the
# sharding rules map them onto a mesh)
ATTENTION_AXES = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
                  "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
                  "q_norm": ("head_dim",), "k_norm": ("head_dim",)}


def attention_init(ini, cfg) -> dict:
    """Projection weights for (GQA) self / cross attention."""
    d, hd, hq, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": ini.normal((d, hq * hd)), "wk": ini.normal((d, hkv * hd)),
         "wv": ini.normal((d, hkv * hd)), "wo": ini.normal((hq * hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = ini.ones((hd,))
        p["k_norm"] = ini.ones((hd,))
    return p


def _project(p, cfg, x, kv_src):
    """q, k, v.  The weights are in x's dtype; K/V from a source of a
    wider dtype (float32 image embeddings under a bf16 config) are
    computed in that dtype, the weights widened exactly, as JAX promotes
    the reference's `kv_x @ w.astype(x.dtype)`."""
    b, s, _ = x.shape
    t = kv_src.shape[1]
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    kv_dt = torch.promote_types(kv_src.dtype, x.dtype)
    kv_src = kv_src.to(kv_dt)
    # `matmul`: on a mesh the sequence shards are gathered first
    # (Megatron-SP)
    q = matmul(x, p["wq"]).reshape(b, s, hq, hd)
    k = matmul(kv_src, p["wk"].to(kv_dt)).reshape(b, t, hkv, hd)
    v = matmul(kv_src, p["wv"].to(kv_dt)).reshape(b, t, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _core_layout(q, k) -> tuple:
    """The placements the attention core runs at on a mesh: the batch as
    the rules shard it, the sequence whole, and the heads of q and of k/v
    on "model" where both divide it (else whole), so that each rank's q
    heads meet their own KV heads; the layout `cfg.attn_gather` names."""
    tq = target_placements(q, ("batch", None, "heads", None))
    tk = target_placements(k, ("batch", None, "kv_heads", None))
    if tq != tk:
        tq = tk = tuple(Replicate() if isinstance(p, Shard) and p.dim == 2
                        else p for p in tq)
    return tq


def _attend(q, k, v, cfg, *, causal: bool):
    """Blockwise attention of q/k/v, on their local shards at
    `_core_layout` when they are DTensors."""
    at = _core_layout(q, k) if is_dtensor(q) else None
    out = blockwise_attention(to_local_at(q, at), to_local_at(k, at),
                              to_local_at(v, at), causal=causal,
                              q_chunk=cfg.attn_q_chunk,
                              k_chunk=cfg.attn_k_chunk)
    return from_local_at(out, q, at)


def decode_on_shards(q, k, v, cache, index: int, k_chunk: int,
                     length: int | None = None):
    """The decode step's cache write and attention when the cache
    {k, v} (B,T,Hkv,hd) is a DTensor, possibly split on T: the new K/V
    row (k, v: (B,1,Hkv,hd), or None to attend without writing, as
    whisper's cross K/V) is written on the rank whose shard holds `index`
    (through `to_local()`), each rank attends its own shard's part of the
    valid prefix (`length`, by default index + 1), and the ranks that
    split T combine their online-softmax states (a max and two sums over
    each such mesh dim).  q (B,1,Hq,hd); returns (B,1,Hq,hd) at q's
    dtype, placed as the cache (T whole)."""
    kc, vc = cache["k"], cache["v"]
    mesh, pl = kc.device_mesh, kc.placements
    seq = [i for i, p in enumerate(pl)
           if isinstance(p, Shard) and p.dim == 1 and mesh.size(i) > 1]
    at = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in pl)
    ql = to_local_at(q, at)
    kcl, vcl = kc.to_local(), vc.to_local()
    _, off = local_shape_and_offset(kc.shape, mesh, pl)
    t0, tl, s = off[1], kcl.shape[1], q.shape[1]
    if k is not None:
        kl, vl = to_local_at(k, at), to_local_at(v, at)
        lo, hi = max(index, t0), min(index + s, t0 + tl)
        if lo < hi:
            kcl[:, lo - t0:hi - t0] = kl[:, lo - index:hi - index]
            vcl[:, lo - t0:hi - t0] = vl[:, lo - index:hi - index]
    length = index + s if length is None else length
    m, l, o = decode_attention_state(ql[:, 0], kcl, vcl, length - t0,
                                     k_chunk)
    for i in seq:
        group = mesh.get_group(i)
        top = funcol.all_reduce(m, "max", group)
        w = torch.exp(m - top)
        l = funcol.all_reduce(l * w, "sum", group)
        o = funcol.all_reduce(o * w[..., None], "sum", group)
        m = top
    out = (o / torch.clamp(l, min=1e-30)[..., None])[:, None]
    return from_local_at(out.to(q.dtype), q, at)


def _out_proj(out, p, cfg):
    """(B, S, Hq, hd) -> the block output (B, S, D) through wo (the rows
    made safe to flatten on a mesh, as in `_project`)."""
    b, s = out.shape[:2]
    return matmul(out.reshape(b, s, cfg.n_heads * cfg.hd), p["wo"])


def cross_attention(p, cfg, x, kv_x=None):
    """The reference's `attention_apply` with `causal=False`, `rope=False`
    and no cache: the vlm's `cross` block and whisper's cross-attention,
    K/V from `kv_x` (B, T, D) (the image embeddings, the encoder's
    output), and whisper's encoder self-attention, K/V from x itself (as
    the vlm's block when the reference's launcher passes no images).
    Returns (B, S, D)."""
    b, s, _ = x.shape
    q, k, v = _project(p, cfg, x, x if kv_x is None else kv_x)
    out = _attend(q, k, v, cfg, causal=False)
    return _out_proj(out, p, cfg)


def attention_apply(p, cfg, x, *, positions=None, cache=None,
                    cache_index: int = 0, rope: bool = True):
    """GQA self-attention.  x: (B,S,D); `p` holds the projections in x's
    dtype; positions (1, S) default to 0..S-1; `rope=False` leaves q and
    k unrotated (whisper's decoder, whose positions are learned).
    Without a cache: causal blockwise attention over the sequence
    (training and prefill).  With a cache {k, v}: (B,T,Hkv,hd), the
    decode path: the cache is updated in place at `cache_index` (the
    reference returns a new cache) and the query attends its valid
    prefix.  On a mesh (DTensor activations and weights) the attention
    core runs on local shards: `_attend`, and `decode_on_shards` for a
    cache split over ranks.  Returns the block output (B,S,D)."""
    b, s, _ = x.shape
    if positions is None:
        positions = replicated_like(torch.arange(s, device=x.device)[None, :],
                                    x)
    q, k, v = _project(p, cfg, x, x)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None and cfg.attn_gather:
        # Megatron-SP: one explicit seq gather here; the blockwise chunks
        # then slice locally (heads stay model-sharded)
        q = constrain(q, ("batch", None, "heads", None))
        k = constrain(k, ("batch", None, "kv_heads", None))
        v = constrain(v, ("batch", None, "kv_heads", None))
    if cache is None:
        out = _attend(q, k, v, cfg, causal=True)
        return _out_proj(out, p, cfg)
    if is_dtensor(cache["k"]):
        out = decode_on_shards(q, k, v, cache, cache_index,
                               cfg.attn_k_chunk)
        return _out_proj(out, p, cfg)
    cache["k"][:, cache_index:cache_index + s] = k
    cache["v"][:, cache_index:cache_index + s] = v
    out = chunked_decode_attention(
        q[:, 0], cache["k"], cache["v"], length=cache_index + s,
        k_chunk=cfg.attn_k_chunk)[:, None]
    return _out_proj(out, p, cfg)
