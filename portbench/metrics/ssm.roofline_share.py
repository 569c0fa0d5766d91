"""ssm.roofline_share (%): the Mamba-2 blocks' least time a decode step
over their device time a step (`ssm.decode_ms`'s).  The least time is the
traffic kind's `ssm_min_bytes` (the blocks' weights read once, each
sequence's float32 state read and written once) at the card's HBM
bandwidth.  None where the program opens no `ssm.decode` span or the
traffic kind counts no SSM bytes."""

from portbench import yardstick


def read(record):
    s = record["trace"]["span_device_s"].get("ssm.decode")
    if not s or "ssm_min_bytes" not in record or not record.get("steps"):
        return None
    least = (record["ssm_min_bytes"] / record["steps"]
             / yardstick.PEAK_HBM_BYTES_PER_S)
    return 100.0 * least / (s / record["trace"]["span_steps"])
