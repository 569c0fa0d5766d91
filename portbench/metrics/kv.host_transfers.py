"""kv.host_transfers (count/step): the host crossings of the tier a step,
from `repro_torch.obs.snapshot()`'s counters: host arrays put on the
card (`host.h2d`: the cache's staged index and mask arrays, and any row
the caller hands over in host memory) plus device-to-host reads
(`host.d2h`), over the number of `serve.attend` spans (one a step).

The snapshot covers the harness's two traced passes alone (the program
records only while a torch profiler runs).  None where the program has
no `repro_torch.obs` or opened no `serve.attend`."""


def read(record):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    snap = obs.snapshot()
    steps = snap["spans"].get("serve.attend", {}).get("n", 0)
    if not steps:
        return None
    c = snap["counts"]
    return (c.get("host.h2d", 0) + c.get("host.d2h", 0)) / steps
