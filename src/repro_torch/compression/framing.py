"""Marker framing: the constants of the in-band-metadata discipline.

A copy of `repro.compression.framing` (kept in numpy, bit for bit): a
64-byte slot whose last 4 bytes are a keyed per-slot marker; for KV
strips the 4 marker bytes are two int16 lanes at the strip tail.  The
device marker family is an affine keyed hash that wraps identically in
int32 and uint32; a `domain` salt separates pair markers from quad
markers so the two can never alias.
"""

from __future__ import annotations

import numpy as np

LINE_BYTES = 64                 # the paper's cache-line / DMA granule
SLOT_BUDGET = 64                # one physical slot = one line
MARKER_BYTES = 4                # in-band marker at the slot tail
MARKER_LANES = 2                # the same 4 bytes as 2 int16 lanes (KV strips)
PAYLOAD_BUDGET = SLOT_BUDGET - MARKER_BYTES   # 60B usable when packed
HEADER_BYTES = 1                # per-sub-line algorithm header (counted)

# marker-class domains (salt the key, not the index, so domain 0 stays
# bit-identical to the historical pair markers)
DOMAIN_PAIR = 0
DOMAIN_QUAD = 1
_DOMAIN_SALT = 0x9E3779B9

# the default marker key of every keyed entry point
DEFAULT_MARKER_KEY = 0x5EED

FIB_MULT = 0x9E3779B1                   # the odd 32-bit golden constant
M2_MULT = FIB_MULT                      # 2:1 pair-marker multiplier
M4_MULT = 0x85EBCA6B                    # 4:1 quad-marker multiplier
IL_MULT = 0x27D4EB2F                    # interleave/mix multiplier


def slot_markers(n_slots: int, key: int = DEFAULT_MARKER_KEY,
                 domain: int = DOMAIN_PAIR) -> np.ndarray:
    """Per-slot 32-bit device markers (keyed affine hash; regenerable)."""
    idx = np.arange(n_slots, dtype=np.uint64)
    k = np.uint64((key + domain * _DOMAIN_SALT) & 0xFFFFFFFFFFFFFFFF)
    h = (idx * np.uint64(0x9E3779B97F4A7C15) + k) >> np.uint64(13)
    return (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def marker_to_lanes(m: np.ndarray) -> np.ndarray:
    """uint32 marker -> two int16 lanes (little-endian halves)."""
    lo = (m & 0xFFFF).astype(np.uint16).view(np.int16)
    hi = ((m >> 16) & 0xFFFF).astype(np.uint16).view(np.int16)
    return np.stack([lo, hi], axis=-1)


def lanes_to_marker_i32(tail, xp=np):
    """Two int16 tail lanes -> the int32 marker bit pattern (numpy)."""
    t = tail.astype(xp.int32)
    return (t[..., 0] & 0xFFFF) | ((t[..., 1] & 0xFFFF) << 16)
