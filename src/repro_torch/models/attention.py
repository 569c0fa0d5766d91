"""Blockwise attention in plain torch (port of `repro.models.attention`:
causal self-attention over a whole sequence for training and prefill,
decode self-attention against a cache, and the cross-attention).  Scores
are materialised one (q_chunk x k_chunk) block at a time with an
online-softmax (max, denom, acc) state, in the reference's order of
operations and with its -1e30 masking; GQA repeats each KV head for its
G query heads, chunk by chunk.  Under autograd each q-chunk is recomputed
in backward (the reference's `jax.checkpoint` of its q-chunk body), so
the scores of one chunk at a time are live."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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


def _q_chunk(qc, kb, vb, qpos, k_pos, causal: bool, kv_length):
    """One q-chunk against every k-chunk: qc (B,Hq,qc,D) scaled, kb/vb
    (nk,B,kc,Hkv,D), qpos (qc,), k_pos (nk,kc) -> (B,Hq,qc,D) float32."""
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


def chunked_decode_attention(q, k_cache, v_cache, length,
                             k_chunk: int = 2048):
    """Single-token decode: q (B,Hq,D) against cache (B,T,Hkv,D) with
    `length` valid positions."""
    out = blockwise_attention(
        q[:, None], k_cache, v_cache, causal=False, q_chunk=1,
        k_chunk=min(k_chunk, k_cache.shape[1]), kv_length=length)
    return out[:, 0]


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
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (kv_src @ p["wk"].to(kv_dt)).reshape(b, t, hkv, hd)
    v = (kv_src @ p["wv"].to(kv_dt)).reshape(b, t, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def cross_attention(p, cfg, x, kv_x=None):
    """The reference's `attention_apply` with `causal=False`, `rope=False`
    and no cache: the vlm's `cross` block and whisper's cross-attention,
    K/V from `kv_x` (B, T, D) (the image embeddings, the encoder's
    output), and whisper's encoder self-attention, K/V from x itself (as
    the vlm's block when the reference's launcher passes no images).
    Returns (B, S, D)."""
    b, s, _ = x.shape
    q, k, v = _project(p, cfg, x, x if kv_x is None else kv_x)
    out = blockwise_attention(q, k, v, causal=False,
                              q_chunk=cfg.attn_q_chunk,
                              k_chunk=cfg.attn_k_chunk)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]


def attention_apply(p, cfg, x, *, positions=None, cache=None,
                    cache_index: int = 0, rope: bool = True):
    """GQA self-attention.  x: (B,S,D); `p` holds the projections in x's
    dtype; positions (1, S) default to 0..S-1; `rope=False` leaves q and
    k unrotated (whisper's decoder, whose positions are learned).
    Without a cache: causal blockwise attention over the sequence
    (training and prefill).  With a cache {k, v}: (B,T,Hkv,hd), the
    decode path: the cache is updated in place at `cache_index` (the
    reference returns a new cache) and the query attends its valid
    prefix.  Returns the block output (B,S,D)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project(p, cfg, x, x)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = blockwise_attention(q, k, v, causal=True,
                                  q_chunk=cfg.attn_q_chunk,
                                  k_chunk=cfg.attn_k_chunk)
        return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]
    cache["k"][:, cache_index:cache_index + s] = k
    cache["v"][:, cache_index:cache_index + s] = v
    out = chunked_decode_attention(
        q[:, 0], cache["k"], cache["v"], length=cache_index + s,
        k_chunk=cfg.attn_k_chunk)[:, None]
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]
