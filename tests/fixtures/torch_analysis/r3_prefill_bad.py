"""R3 fixture: host syncs inside prefill-named hot paths.

The chunked-prefill ingest is a hot path like the decode step: a
`prefill`/`prefill_slot` entry that syncs the card or books the ledger
per call undoes the one-launch win."""

import torch


class Loop:
    def prefill(self, seq_id, k, v, ledger):
        rec = self.admit(seq_id, prompt=(k, v))
        ledger.record("spill", k.nbytes, k.nbytes)     # per-admit booking
        torch.cuda.synchronize()                       # mid-ingest sync
        return rec


class Cache:
    def prefill_slot(self, slot, k, v, ledger):
        st = self.state
        total = st["counter"].sum()
        n = total.item()                               # blocking read-back
        ledger.record("repack", n, n)                  # per-call booking
        torch.cuda.current_stream().synchronize()      # another sync
        return n
