"""R6 fixture: swallowed kernel errors, a fallback to the plain version,
and float64."""

import numpy as np
import torch


def safe_decode(kernel, pages):
    try:
        return kernel(pages)
    except:  # noqa: E722  bare except around a launch
        pass
    try:
        return kernel(pages)
    except RuntimeError:
        return pages.sum(0)               # falls back to a plain version
    acc = pages.double()                  # float64
    acc = acc.to(torch.float64)           # float64
    return np.zeros(3, dtype=float), acc  # python float dtype: float64


def launch(kernel, pages):
    try:
        return kernel(pages)
    except RuntimeError as e:             # re-raised: not flagged
        raise ValueError("launch failed") from e
