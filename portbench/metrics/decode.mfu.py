"""decode.mfu (%): the model FLOPs of the traced decode steps (the
yardstick's count) over the traced window's length and the card's bf16
peak."""

from portbench import yardstick


def read(record):
    if "flops" not in record:
        return None
    return (100.0 * record["flops"] / record["trace"]["window_s"]
            / yardstick.PEAK_BF16_FLOPS)
