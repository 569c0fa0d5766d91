"""kv.llp_accuracy (%): the line location predictor's hits over its
lookups in the traced window (the cache's `pred_hits` / `pred_misses`
counters)."""


def read(record):
    n = record.get("llp_hits", 0) + record.get("llp_misses", 0)
    return None if not n else 100.0 * record["llp_hits"] / n
