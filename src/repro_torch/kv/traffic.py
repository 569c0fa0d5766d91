"""Synthetic KV decode traffic for tests and the chip smoke run (a numpy
copy of `repro.kv.traffic`, so the port and the reference draw the same
streams from the same seed).
"""

from __future__ import annotations

import numpy as np


def synthetic_kv_stream(rng, batch: int, n_tokens: int, n_kv: int,
                        head_dim: int, *, compressible: bool = True,
                        scale: float = 2e-3):
    """(k, v) float32 arrays of shape (batch, n_tokens, n_kv, head_dim).

    Compressible streams hover multiplicatively (`scale`) around a shared
    per-(head, dim) base, so bf16 pages delta-pack against the pair base;
    incompressible streams are unit normals, which never fit int8 deltas.
    """
    base = 2.0 + rng.standard_normal((batch, 1, n_kv, head_dim)) * 0.2
    shape = (batch, n_tokens, n_kv, head_dim)
    if compressible:
        k = base * (1 + rng.standard_normal(shape) * scale)
        v = base * (1 + rng.standard_normal(shape) * scale)
    else:
        k = rng.standard_normal(shape)
        v = rng.standard_normal(shape)
    return k.astype(np.float32), v.astype(np.float32)
