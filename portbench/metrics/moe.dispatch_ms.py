"""moe.dispatch_ms (ms): device time a step of the operations launched
inside the program's `moe.route`, `moe.dispatch` and `moe.combine` spans
(`models/moe.py:moe_apply`: the router and the top-k, the build of the
(E, C, D) buffer, the gather, gate and sum): the MoE layer less its
expert matmuls (`moe.experts`).  None where the program opens none of
them."""

SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(record):
    by_span = record["trace"]["span_device_s"]
    found = [by_span[n] for n in SPANS if n in by_span]
    if not found:
        return None
    return 1e3 * sum(found) / record["trace"]["span_steps"]
