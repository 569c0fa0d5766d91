"""R2 fixture: bypasses the compression registry three ways."""

import torch

from repro_torch.compression import fpc  # noqa: F401  (impl import, no sanction)


def pack_pair(a, b):  # impl-signature name outside the registry
    import numpy as np
    return np.packbits(torch.bitwise_xor(a, b).numpy())  # codec work
