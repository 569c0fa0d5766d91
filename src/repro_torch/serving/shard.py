"""Decode-attend over the slot axis (port of the single-device branch of
`repro.serving.shard`).  Sharding the slot axis across cards comes with
a later slice; `shard=True` raises until then."""

from __future__ import annotations

import torch

from ..kernels import ops as kops


def shard_kv_attend(cache, q, *, shard: "bool | str" = "auto"):
    """One batched decode-attend over `cache` (a CRAMKVCache or
    SlotKVCache).  q: (B, Hq, d) one query row per slot.  Returns
    (B, Hq, d) float32.  No bandwidth accounting here — callers charge
    the step explicitly."""
    if shard is True:
        raise NotImplementedError("sharded attend: port slice 2")
    cache.repack()
    q = torch.as_tensor(q, device=cache.device)
    if q.dim() == 2:
        q = q[None]
    n = cache._active_bucket()
    decode = (kops.decode_attention_batched if cache.packing == "pair"
              else kops.decode_attention_quad_batched)
    return decode(q, cache._kernel_cache(n), cache._valid(n))


__all__ = ["shard_kv_attend"]
