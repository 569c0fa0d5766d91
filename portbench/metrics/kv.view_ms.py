"""kv.view_ms (ms): device time a step of the operations launched inside
the program's `cache.view` span (`kernels/ops.py:decode_attention_fused`:
the physical view of the cache and its contiguous copies before K3).
None where the program opens no such span."""


def read(record):
    s = record["trace"]["span_device_s"].get("cache.view")
    return None if s is None else 1e3 * s / record["trace"]["span_steps"]
