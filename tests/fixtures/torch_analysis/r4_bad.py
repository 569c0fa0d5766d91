"""R4 fixture: process-salted and global-state seeding."""

import numpy as np
import torch


def trace_seed(name: str) -> int:
    np.random.seed(0)              # global-state seeding
    torch.manual_seed(0)           # and torch's
    torch.cuda.manual_seed_all(0)  # and the card's
    return hash(name) & 0xFFFF     # salted per process (PYTHONHASHSEED)


def fine(seed: int):
    gen = torch.Generator()
    gen.manual_seed(seed)          # an explicit generator: not flagged
    return gen, np.random.default_rng(seed)
