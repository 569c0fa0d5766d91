"""kv.hbm_share (%): the least bytes the traced tier steps move (K3's
layout bytes by the reference's count, the query rows in and out, and
each appended K||V row written once) over the traced window's length
and the card's HBM bandwidth."""

from portbench import yardstick


def read(record):
    if "k3_bytes" not in record:
        return None
    return (100.0 * record["min_bytes"] / record["trace"]["window_s"]
            / yardstick.PEAK_HBM_BYTES_PER_S)
