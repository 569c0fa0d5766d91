"""The reference's random draws, reproduced in torch: `jax.random.key`,
`split` and `normal` of JAX's default threefry2x32 generator in its
partitionable mode, so that a seed gives the reference's initial weights
without JAX (the training launcher's `--seed`, held against the
reference's launcher step by step).

Words are uint32 values carried in int64 tensors (torch has no full
uint32 arithmetic on every device) and masked after each add and shift.
A draw of n values hashes the 64-bit counters 0..n-1 (split into high and
low words) under the key and xors the two output words; `normal` turns
the bits into a float32 uniform on (-1, 1) as `jax.random.uniform` does
and maps it through the float32 erfinv polynomial that XLA lowers
`lax.erf_inv` to, times sqrt(2).  The integer steps are exact; the float
steps are the reference's float32 operations (each Horner step of the
polynomial fused, as XLA fuses it), so a draw equals the reference's
bits for some 99% of values and is within 3 ulps of it elsewhere, where
`log1p` rounds differently (`tests/test_torch_train_launch.py`).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# draws are made this many values at a time, bounding the int64 temporaries
_CHUNK = 1 << 22

# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"):
# coefficients for w = -log1p(-x^2) < 5 (in w - 2.5) and otherwise (in
# sqrt(w) - 3), highest power first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x1, x2):
    """The threefry2x32 hash of counter words (x1, x2) (int64 tensors of
    uint32 values) under the key (k1, k2); returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def key(seed: int) -> tuple[int, int]:
    """`jax.random.key(seed)`: the seed's high and low 32 bits."""
    return (seed >> 32) & _MASK, seed & _MASK


def split(k: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """`jax.random.split(k, num)`: key i hashes the counter i."""
    lo = torch.arange(num, dtype=torch.int64)
    b1, b2 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return list(zip(b1.tolist(), b2.tolist()))


def random_bits(k: tuple[int, int], start: int, n: int, device):
    """32 random bits for the flat indices start..start+n-1 of a draw,
    as an int64 tensor."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k[0], k[1], idx >> 32, idx & _MASK)
    return b1 ^ b2


def _erfinv(x):
    """XLA's float32 erfinv of x in (-1, 1); each Horner step c + p * w is
    one fused multiply-add there, taken here in float64 and rounded once
    to float32."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)

    def coef(i):     # the float32 constants, as float64
        return torch.where(lt, float(np.float32(_ERFINV_LT5[i])),
                           float(np.float32(_ERFINV_GE5[i]))).to(w.dtype)

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = (coef(i) + p * w).to(torch.float32).to(torch.float64)
    return p.to(torch.float32) * x


def normal(k: tuple[int, int], shape, device="cpu") -> torch.Tensor:
    """`jax.random.normal(k, shape, float32)` on `device`."""
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape)) if shape else 1
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    span = np.float32(1.0) - lo
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, _CHUNK):
        m = min(_CHUNK, n - start)
        bits = random_bits(k, start, m, device)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
        u = torch.clamp_min((f - 1.0) * float(span) + float(lo), float(lo))
        out[start:start + m] = _erfinv(u) * float(np.float32(np.sqrt(2)))
    return out.reshape(shape)


class ReferenceInitializer:
    """The reference's `Initializer` (normal / sqrt(fan_in) unless a scale
    is given, ones, zeros, constants), drawing each normal tensor from the
    next key split off `seed`'s key, as the reference does.  A `stacked`
    view prepends a leading axis to every shape, as the reference's
    `_Stacked` proxy does for the super-block positions (one draw for the
    whole stack)."""

    def __init__(self, seed: int, device, param_dtype):
        self._keys = [key(seed)]       # shared with the stacked views
        self.device = torch.device(device)
        self.param_dtype = param_dtype
        self.lead = ()

    def stacked(self, n: int) -> "ReferenceInitializer":
        """A view that prepends (n,) to every shape and draws from this
        initializer's key stream."""
        view = copy.copy(self)
        view.lead = (n,)
        return view

    def _next_key(self):
        self._keys[0], sub = split(self._keys[0])
        return sub

    def normal(self, shape, scale=None):
        shape = self.lead + tuple(shape)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
        w = normal(self._next_key(), shape, self.device)
        return (w * float(np.float32(scale))).to(self.param_dtype)

    def const(self, shape, value: float):
        return torch.full(self.lead + tuple(shape), value,
                          dtype=self.param_dtype, device=self.device)

    def ones(self, shape):
        return self.const(shape, 1.0)

    def zeros(self, shape):
        return self.const(shape, 0.0)
