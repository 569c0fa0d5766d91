"""repro_torch.serving — the continuous-batching serve tier with the
compressed KV spill tier.

  slots   — SlotKVCache: the batched CRAM-KV cache with per-slot sequence
            lifetimes
  migrate — incremental live migration between gates and packings
  spill   — SpillStore: the host tier holding cold sequences still
            compressed under its own packing; bit-exact resurrection
  shard   — decode-attend over the slot axis, sharded across devices
  loop    — ServeLoop: admit / prefill / step / attend / retire / evict /
            wake, and per-tier AutoTuner observation windows
"""

from .loop import SequenceSlot, ServeLoop
from .shard import shard_kv_attend
from .slots import SlotKVCache
from .spill import SPILL_LANES, SpilledSeq, SpillStore

__all__ = [
    "ServeLoop", "SequenceSlot", "SlotKVCache",
    "SpillStore", "SpilledSeq", "SPILL_LANES",
    "shard_kv_attend",
]
