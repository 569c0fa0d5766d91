"""Bit-stream reader/writer used by the exact (byte-level) codec paths
(a copy of `repro.compression.bits`).

Host-side numpy/python utilities: the exact pack/unpack paths exist for
correctness tests and the checkpoint codec; sizes over a whole image come
from the one-pass scan kernel (`kernels/compress_scan.py`).
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """MSB-first bit accumulator producing a byte string."""

    __slots__ = ("_bits",)

    def __init__(self) -> None:
        self._bits: list[int] = []

    def write(self, value: int, nbits: int) -> None:
        if nbits < 0:
            raise ValueError("nbits must be >= 0")
        if value < 0 or (nbits < 64 and value >> nbits):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        for i in range(nbits - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def write_signed(self, value: int, nbits: int) -> None:
        """Two's-complement write of a signed integer."""
        self.write(value & ((1 << nbits) - 1), nbits)

    def __len__(self) -> int:  # number of bits written
        return len(self._bits)

    def getvalue(self) -> bytes:
        bits = self._bits
        nbytes = (len(bits) + 7) // 8
        out = bytearray(nbytes)
        for i, b in enumerate(bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


class BitReader:
    """MSB-first bit reader over a byte string."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0

    def read(self, nbits: int) -> int:
        value = 0
        pos = self._pos
        data = self._data
        for _ in range(nbits):
            byte = data[pos >> 3]
            value = (value << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self._pos = pos
        return value

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        if v & (1 << (nbits - 1)):
            v -= 1 << nbits
        return v

    @property
    def bit_position(self) -> int:
        return self._pos


def sign_extend(value: int, nbits: int) -> int:
    value &= (1 << nbits) - 1
    if value & (1 << (nbits - 1)):
        value -= 1 << nbits
    return value


def bytes_to_u32(line: np.ndarray) -> np.ndarray:
    """(…,64) uint8 -> (…,16) uint32, little-endian (x86 memory image)."""
    line = np.ascontiguousarray(line, dtype=np.uint8)
    return line.view("<u4").reshape(line.shape[:-1] + (16,))


def u32_to_bytes(words: np.ndarray) -> np.ndarray:
    words = np.ascontiguousarray(words, dtype="<u4")
    return words.view(np.uint8).reshape(words.shape[:-1] + (64,))
