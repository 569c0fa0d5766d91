"""repro_torch.serving — the continuous-batching serve tier.

  slots   — SlotKVCache: the batched CRAM-KV cache with per-slot sequence
            lifetimes
  migrate — incremental live migration between gates and packings
  shard   — decode-attend over the slot axis (single device)
  loop    — ServeLoop: admit / prefill / step / attend / retire
"""

from .loop import SequenceSlot, ServeLoop
from .shard import shard_kv_attend
from .slots import SlotKVCache

__all__ = ["ServeLoop", "SequenceSlot", "SlotKVCache", "shard_kv_attend"]
