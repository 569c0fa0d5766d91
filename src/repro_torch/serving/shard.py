"""Decode-attend over the slot axis, sharded across devices (port of
`repro.serving.shard`).

Sequence slots are independent, so the batched decode partitions over
devices with no collectives, as the reference's `shard_map` over its
local devices does: slot shard i of (q, slots, slots_overflow, strips,
packed_mask, valid) goes to `devices[i]` with the marker table
replicated, each shard is one K3 launch on that device's current stream,
and the outputs are gathered in slot order onto the cache's device.
`shard="auto"` shards when there are several devices, `shard=True` asks
for it; both run the single-device decode when there is one device or
the slot count does not divide by the device count.  `devices` defaults
to every visible card for a cache on a card (the CPU for a CPU cache); a
list may name one device more than once, which is how one card runs the
sharded path.  K3's split rule depends only on the slots of a sequence,
not on B, so the sharded and single-device paths are bit-identical."""

from __future__ import annotations

import torch

from ..device import device_list, on_device
from ..kernels import ops as kops


def shard_kv_attend(cache, q, *, shard: "bool | str" = "auto",
                    devices=None):
    """One batched decode-attend over `cache` (a CRAMKVCache or
    SlotKVCache), optionally sharded over the slot axis.  q: (B, Hq, d)
    one query row per slot.  Returns (B, Hq, d) float32 on the cache's
    device.  No bandwidth accounting here — callers charge the step
    explicitly."""
    q = cache._q(q)
    devs = device_list(devices, cache.device)
    n_dev, b = len(devs), q.shape[0]
    want = shard is True or (shard == "auto" and n_dev > 1)
    if not want or n_dev <= 1 or b % n_dev:
        return cache.attend(q, account=False)
    _, kc, valid = cache._attend_inputs()
    per = b // n_dev
    outs = []
    for i, dev in enumerate(devs):
        rows = slice(i * per, (i + 1) * per)
        with on_device(dev):
            shard_cache = {k: (v if k == "markers" else v[rows]).to(dev)
                           for k, v in kc.items()}
            outs.append(kops.decode_attention_fused(
                q[rows].to(dev), shard_cache, valid[rows].to(dev),
                lanes=cache.group_lanes)[0])
    return torch.cat([o.to(cache.device) for o in outs])


__all__ = ["shard_kv_attend"]
