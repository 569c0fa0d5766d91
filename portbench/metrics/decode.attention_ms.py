"""decode.attention_ms (ms): device time a step of the operations launched
inside the model's decode attention (`models/attention.py:
chunked_decode_attention`, the `decode.attention` span)."""


def read(record):
    s = record["trace"]["span_device_s"].get("decode.attention")
    return None if s is None else 1e3 * s / record["trace"]["span_steps"]
