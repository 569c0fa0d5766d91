"""kv.step_ms (ms): device time a step of the operations launched inside
`ServeLoop.step_all` (append, window pack, byte booking: the `kv.step`
span)."""


def read(record):
    s = record["trace"]["span_device_s"].get("kv.step")
    return None if s is None else 1e3 * s / record["trace"]["span_steps"]
