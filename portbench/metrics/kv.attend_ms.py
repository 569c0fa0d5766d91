"""kv.attend_ms (ms): device time a step of the operations launched
inside `ServeLoop.attend` (the physical view and K3: the `kv.attend`
span)."""


def read(record):
    s = record["trace"]["span_device_s"].get("kv.attend")
    return None if s is None else 1e3 * s / record["trace"]["span_steps"]
