"""k3.roofline_share (%): K3's least time over its device time in the
traced window.  The least time is the larger of its bytes (the layout's
slots and strips of every live group by the reference's count, the
query rows in and out) over the HBM bandwidth and its FLOPs over the
float32 rate it computes at.  Its device time is that of its kernels
(`cram_decode_*`, the decode and the merge)."""

from portbench import yardstick

PEAK_FP32_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores


def read(record):
    if "k3_bytes" not in record:
        return None
    t = sum(s for name, s in record["trace"]["device_s"].items()
            if "cram_decode" in name)
    if t <= 0:
        return None
    least = max(record["k3_bytes"] / yardstick.PEAK_HBM_BYTES_PER_S,
                record["attend_flops"] / PEAK_FP32_FLOPS)
    return 100.0 * least / t
