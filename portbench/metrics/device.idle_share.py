"""device.idle_share (%): the share of the traced window in which no
operation ran on the device (torch.profiler)."""


def read(record):
    t = record["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
