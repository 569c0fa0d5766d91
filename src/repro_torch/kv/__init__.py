"""Batched paged KV cache with incremental CRAM packing."""

from .cache import CRAMKVCache, KVStats
from .traffic import synthetic_kv_stream

__all__ = ["CRAMKVCache", "KVStats", "synthetic_kv_stream"]
