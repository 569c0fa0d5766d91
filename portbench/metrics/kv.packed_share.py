"""kv.packed_share (%): packed page groups over live page groups in the
cache at the end of the traced window (the cache's packed mask)."""


def read(record):
    if not record.get("live_groups"):
        return None
    return 100.0 * record["packed_groups"] / record["live_groups"]
