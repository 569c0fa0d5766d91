"""kv.mfu (%): the attention FLOPs of the traced tier steps (4 x context
x Hq x hd a session) over the traced window's length and the card's
bf16 peak."""

from portbench import yardstick


def read(record):
    if "attend_flops" not in record:
        return None
    return (100.0 * record["attend_flops"] / record["trace"]["window_s"]
            / yardstick.PEAK_BF16_FLOPS)
