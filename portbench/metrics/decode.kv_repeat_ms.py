"""decode.kv_repeat_ms (ms): device time a step of the operations launched
inside the program's `attn.kv_repeat` span (`models/attention.py:
_q_chunk_state`: each K/V chunk repeated for its query heads; a model
whose query heads each have a KV head of their own opens none).  None
where the program opens no such span."""


def read(record):
    s = record["trace"]["span_device_s"].get("attn.kv_repeat")
    return None if s is None else 1e3 * s / record["trace"]["span_steps"]
