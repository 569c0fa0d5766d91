"""attn.roofline_share (%): the model's decode attention kernel's least
time over its device time in the traced window.  Its device time is that
of the operations whose name holds `gqa_decode` (the decode and the
merge of `csrc/gqa_decode.cu`); None where no such kernel ran.  The least
time is the larger of the attention's bytes over the HBM bandwidth and
its FLOPs over the float32 rate it computes at, both taken from the
yardstick's counts of the traced steps less the same steps' counts with
no position attended: the K/V rows of every attended position (the new
row's write counted in its place), and 4 x context x Hq x hd a layer."""

from portbench import yardstick

PEAK_FP32_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores


def attention_counts(record) -> tuple[float, float]:
    """(bytes, FLOPs) of the traced steps' decode attention."""
    cfg, steps = record["config"], record["steps"]
    empty = [0] * (record["tokens"] // steps)
    kv_bytes = (record["min_bytes"]
                - steps * yardstick.decode_step_min_bytes(cfg, empty))
    flops = record["flops"] - steps * yardstick.decode_step_flops(cfg, empty)
    return kv_bytes, flops


def read(record):
    if "min_bytes" not in record or not record.get("steps"):
        return None
    t = sum(s for name, s in record["trace"]["device_s"].items()
            if "gqa_decode" in name)
    if t <= 0:
        return None
    kv_bytes, flops = attention_counts(record)
    least = max(kv_bytes / yardstick.PEAK_HBM_BYTES_PER_S,
                flops / PEAK_FP32_FLOPS)
    return 100.0 * least / t
