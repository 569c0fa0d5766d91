"""The checkpoint manifest's MessagePack encoding, written and read
without the `msgpack` package (which the card's machine lacks).

`packb` gives the bytes `msgpack.packb` gives (use_bin_type=True, float64
floats) for the types a manifest holds: dict, list / tuple, str, int
(-2^63 .. 2^64-1), bool, None, float and bytes, each in its smallest
encoding; `unpackb` reads them back (arrays as lists, as `msgpack.unpackb`
does).
"""

from __future__ import annotations

import struct


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """A length header: a fix code for n <= fix_max (when the type has
    one), else the 8-, 16- or 32-bit form."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] and n < 1 << 8:
        out += bytes([codes[0], n])
    elif n < 1 << 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    elif n < 1 << 32:
        out += bytes([codes[2]]) + struct.pack(">I", n)
    else:
        raise ValueError(f"length {n} too long for MessagePack")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 8), (0xCD, ">H", 16),
                               (0xCE, ">I", 32), (0xCF, ">Q", 64)):
            if v < 1 << top:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit MessagePack's uint64")
    else:
        for code, fmt, top in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                               (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << top):
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit MessagePack's int64")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for x in obj:
            _pack(out, x)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        c = self.num(">B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in fixed:
            return fixed[c]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if c in scalars:
            return self.num(scalars[c])
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
                 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
                 0xDC: ">H", 0xDD: ">I",                  # array
                 0xDE: ">H", 0xDF: ">I"}                  # map
        if c not in sized:
            raise ValueError(f"unsupported MessagePack type 0x{c:02x}")
        n = self.num(sized[c])
        if c in (0xD9, 0xDA, 0xDB):
            return self.take(n).decode("utf-8")
        if c in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        return self.array(n) if c in (0xDC, 0xDD) else self.map(n)

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes):
    r = _Reader(bytes(data))
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the MessagePack object")
    return obj
