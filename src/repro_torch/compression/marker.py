"""Marker generation and implicit-metadata line interpretation (§V-A).

Compressed lines carry a 4-byte *marker* in their last four bytes: one marker
value class for 2-to-1 packed lines and one for 4-to-1.  Vacated slots are
overwritten with a full-line *invalid-line marker* (Marker-IL).  All marker
values are per-line (keyed by the physical slot address) so an adversary
cannot force collisions: the paper uses DES, we use keyed blake2b on the host
path and an affine hash on device paths — the protocol (regenerate keys on
LIT overflow) is what matters, not the particular PRF.

An uncompressed line that coincidentally ends with a marker is stored
*inverted* and its address recorded in the LIT.  The interpretation rules
implemented by `classify_line` are exactly the paper's:

  last4 == marker2      -> line holds 2 compressed lines
  last4 == marker4      -> line holds 4 compressed lines
  whole line == IL      -> slot is invalid (stale), line lives elsewhere
  last4 == ~marker2/4 or whole == ~IL
                        -> uncompressed, *possibly* inverted: consult LIT
  otherwise             -> uncompressed, as-is

A copy of `repro.compression.marker` (host path).  The device marker
family and its one-pass classification are in `kernels/compress_scan.py`.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from .framing import LINE_BYTES, MARKER_BYTES


class LineStatus(IntEnum):
    UNCOMP = 0          # plain uncompressed data
    COMP2 = 1           # two compressed lines
    COMP4 = 2           # four compressed lines
    INVALID = 3         # Marker-IL: slot vacated by relocation
    MAYBE_INVERTED = 4  # uncompressed; matches complement of a marker -> LIT


@dataclass
class MarkerSpec:
    """Per-machine marker key material (regenerated on LIT overflow)."""

    key: bytes = b"cram-default-key"
    generation: int = 0
    _cache: dict = field(default_factory=dict, repr=False)

    def _hash(self, domain: bytes, slot_addr: int, nbytes: int) -> bytes:
        ck = (domain, slot_addr)
        got = self._cache.get(ck)
        if got is None:
            h = hashlib.blake2b(
                domain + slot_addr.to_bytes(8, "little"),
                key=self.key + self.generation.to_bytes(4, "little"),
                digest_size=nbytes,
            )
            got = h.digest()
            self._cache[ck] = got
        return got

    def marker2(self, slot_addr: int) -> bytes:
        return self._hash(b"m2", slot_addr, MARKER_BYTES)

    def marker4(self, slot_addr: int) -> bytes:
        return self._hash(b"m4", slot_addr, MARKER_BYTES)

    def marker_il(self, slot_addr: int) -> bytes:
        return self._hash(b"il", slot_addr, LINE_BYTES)

    def regenerate(self) -> None:
        """New marker generation (paper: on LIT overflow, re-encode memory)."""
        self.generation += 1
        self._cache.clear()


def _inv(b: bytes) -> bytes:
    return bytes(255 - x for x in b)


def classify_line(line: np.ndarray, slot_addr: int, spec: MarkerSpec) -> LineStatus:
    """Interpret a 64-byte line fetched from `slot_addr` (implicit metadata)."""
    lb = bytes(np.asarray(line, dtype=np.uint8).tobytes())
    tail = lb[-MARKER_BYTES:]
    m2, m4 = spec.marker2(slot_addr), spec.marker4(slot_addr)
    if tail == m2:
        return LineStatus.COMP2
    if tail == m4:
        return LineStatus.COMP4
    il = spec.marker_il(slot_addr)
    if lb == il:
        return LineStatus.INVALID
    if tail == _inv(m2) or tail == _inv(m4) or lb == _inv(il):
        return LineStatus.MAYBE_INVERTED
    return LineStatus.UNCOMP


def needs_inversion(line: np.ndarray, slot_addr: int, spec: MarkerSpec) -> bool:
    """Would storing this uncompressed line collide with a marker?"""
    lb = bytes(np.asarray(line, dtype=np.uint8).tobytes())
    tail = lb[-MARKER_BYTES:]
    return (
        tail == spec.marker2(slot_addr)
        or tail == spec.marker4(slot_addr)
        or lb == spec.marker_il(slot_addr)
    )


def invert_line(line: np.ndarray) -> np.ndarray:
    return (255 - np.asarray(line, dtype=np.uint8)).astype(np.uint8)


def collision_probability(bits: int = 32) -> float:
    """P(random uncompressed line matches a marker); < 1e-9 per the paper
    (two 32-bit markers -> 2 * 2^-32 ~ 4.7e-10)."""
    return 2.0 * 2.0 ** (-bits)
