"""R3 fixture: the strict scope.  `SlotKVCache.megastep` is a function
the launch audit runs (the counterpart of a jit body): host
materialisation and data-dependent shapes are flagged there even where a
hot-named method would be allowed them."""

import numpy as np
import torch


class SlotKVCache:
    def megastep(self, slot_ids, k, v):
        slot_ids = np.asarray(slot_ids, np.int64)       # host conversion
        start = int(self.tokens[slot_ids[0]])           # int() of a tensor
        idx = torch.nonzero(self.dirty)[:, 0]           # data-dependent shape
        live = self.valid.masked_select(self.mask)      # and another
        return start, idx, live

    def helper(self, x):
        return int(x.sum())        # not audited, not hot-named: not flagged
