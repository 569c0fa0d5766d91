"""decode.hbm_share (%): the least bytes the traced decode steps move (the
yardstick's count: weights, KV, new rows, logits) over the traced
window's length and the card's HBM bandwidth."""

from portbench import yardstick


def read(record):
    if "flops" not in record:
        return None
    return (100.0 * record["min_bytes"] / record["trace"]["window_s"]
            / yardstick.PEAK_HBM_BYTES_PER_S)
