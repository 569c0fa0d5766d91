"""ssm.decode_ms (ms): device time a step of the operations launched
inside the program's `ssm.decode` span (`models/ssm.py:ssm_decode_step`,
one a Mamba-2 block: its projections, conv, state update, gated norm and
out projection).  None where the program opens no such span."""


def read(record):
    s = record["trace"]["span_device_s"].get("ssm.decode")
    return None if s is None else 1e3 * s / record["trace"]["span_steps"]
