"""Decode-attend over the slot axis (port of `repro.serving.shard`).

As in the reference, `shard=True` runs the single-device decode when there
is one device (a CPU cache, or at most one visible card) or when the slot
count is not a multiple of the device count.  Sharding the slot axis across
several cards is not ported yet (ROADMAP.md, Queue 1: the sharded
attend): there, `shard=True` raises.  `shard="auto"` always runs the single-device decode,
which gives the same result as the reference's sharded one."""

from __future__ import annotations

import torch

from ..kernels import ops as kops


def _device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def shard_kv_attend(cache, q, *, shard: "bool | str" = "auto"):
    """One batched decode-attend over `cache` (a CRAMKVCache or
    SlotKVCache).  q: (B, Hq, d) one query row per slot.  Returns
    (B, Hq, d) float32.  No bandwidth accounting here — callers charge
    the step explicitly."""
    cache.repack()
    q = torch.as_tensor(q, device=cache.device)
    if q.dim() == 2:
        q = q[None]
    n_dev = _device_count(q.device)
    if shard is True and n_dev > 1 and q.shape[0] % n_dev == 0:
        raise NotImplementedError(
            f"sharding the attend over {n_dev} cards is not ported yet "
            "(ROADMAP.md, Queue 1: the sharded attend)")
    n = cache._active_bucket()
    decode = (kops.decode_attention_batched if cache.packing == "pair"
              else kops.decode_attention_quad_batched)
    return decode(q, cache._kernel_cache(n), cache._valid(n))


__all__ = ["shard_kv_attend"]
