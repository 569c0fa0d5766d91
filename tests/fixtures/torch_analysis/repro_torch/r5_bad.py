"""R5 fixture: unledgered tier crossing + byte math outside bandwidth/."""

from repro_torch.bandwidth.adapters import kv_spill_event  # noqa: F401


def evict_page(store, page):
    # tier-crossing emitter that never reaches the imported adapter:
    # bytes move to the spill tier unledgered
    store.pages.pop(page)
    return page


def flush(ledger, nbytes):
    ledger.record("spill", nbytes, nbytes)  # direct booking, own byte math
