"""R3 fixture: host syncs inside hot-named methods."""

import torch


class Loop:
    def step(self, cache, ledger):
        out = cache.attend()
        ledger.record("read", out.nbytes, out.nbytes)   # per-step booking
        total = out.sum()
        torch.cuda.synchronize()                        # mid-loop sync
        return total.item()                             # blocking read-back

    def attend(self, q):
        scores = self.cache @ q
        host = scores.cpu()                             # copy to the host
        return host.numpy(), scores.max().tolist()      # and two more
