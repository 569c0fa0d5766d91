"""kv_read_bytes_per_token (B/token): the KV bytes the tier read over the
window and the traced steps, as the megastep books them (the layout
walked, re-probes included), over the tokens attended."""


def read(record):
    if not record.get("kv_tokens"):
        return None
    return record["kv_read_bytes"] / record["kv_tokens"]
