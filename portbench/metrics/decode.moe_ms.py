"""decode.moe_ms (ms): device time a step of the operations launched
inside the MoE layer (`models/moe.py:moe_apply`, the `decode.moe`
span)."""


def read(record):
    s = record["trace"]["span_device_s"].get("decode.moe")
    return None if s is None else 1e3 * s / record["trace"]["span_steps"]
