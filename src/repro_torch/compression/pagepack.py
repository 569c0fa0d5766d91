"""KV page-packing codecs on torch tensors: int8-delta pairs (2:1) and
int4-delta quads (4:1), bit for bit as `repro.compression.pagepack`.

A KV page is a (page, Hkv, D2) int16 tile of bf16 bit patterns; a group
of pages packs into one physical slot when every element is within a
signed delta range of the shared base row (page A's token-0 row):

  * pair (int8 deltas):  element = (dB & 0xFF) << 8 | (dA & 0xFF)
  * quad (int4 deltas):  element = (dD & 0xF) << 12 | (dC & 0xF) << 8
                                 | (dB & 0xF) << 4  | (dA & 0xF)

All bit work happens in int32 and is masked: torch has no shifts on
uint16 on the CPU.  Leading batch axes broadcast (the page axis is -3).
"""

from __future__ import annotations

import torch

PAIR_DELTA_BITS = 8
QUAD_DELTA_BITS = 4


def to_int16(x32: torch.Tensor) -> torch.Tensor:
    """Low 16 bits of an int32 tensor as int16 (two's-complement wrap)."""
    x = x32 & 0xFFFF
    return torch.where(x >= 0x8000, x - 0x10000, x).to(torch.int16)


def _base(page_a: torch.Tensor) -> torch.Tensor:
    return page_a[..., 0, :, :]


def _deltas(page, base):
    return page.to(torch.int32) - base.to(torch.int32).unsqueeze(-3)


def _fits(delta, bits: int):
    lim = 1 << (bits - 1)
    return (delta >= -lim) & (delta <= lim - 1)


def _all_fit(deltas, bits: int):
    ok = _fits(deltas[0], bits)
    for d in deltas[1:]:
        ok = ok & _fits(d, bits)
    return ok.flatten(-3).all(-1)


def pack_pair(page_a, page_b):
    """(..., page, Hkv, D2) int16 x2 -> (ok, packed int16, base int16)."""
    base = _base(page_a)
    da, db = _deltas(page_a, base), _deltas(page_b, base)
    ok = _all_fit((da, db), PAIR_DELTA_BITS)
    packed = to_int16(((db & 0xFF) << 8) | (da & 0xFF))
    return ok, packed, base


def _sext(x, bits: int):
    """Sign-extend the low `bits` bits of an int32 tensor."""
    half = 1 << (bits - 1)
    return (x ^ half) - half


def unpack_pair(packed, base):
    """Inverse of pack_pair -> (page_a, page_b) int16."""
    v = packed.to(torch.int32) & 0xFFFF
    b32 = base.to(torch.int32).unsqueeze(-3)
    return (to_int16(b32 + _sext(v & 0xFF, 8)),
            to_int16(b32 + _sext((v >> 8) & 0xFF, 8)))


def pack_quad(page_a, page_b, page_c, page_d):
    """Four (..., page, Hkv, D2) int16 pages -> (ok, packed, base)."""
    base = _base(page_a)
    ds = [_deltas(p, base) for p in (page_a, page_b, page_c, page_d)]
    ok = _all_fit(ds, QUAD_DELTA_BITS)
    packed = ((ds[3] & 0xF) << 12 | (ds[2] & 0xF) << 8
              | (ds[1] & 0xF) << 4 | (ds[0] & 0xF))
    return ok, to_int16(packed), base


def unpack_quad(packed, base):
    """Inverse of pack_quad -> (page_a, page_b, page_c, page_d) int16."""
    v = packed.to(torch.int32) & 0xFFFF
    b32 = base.to(torch.int32).unsqueeze(-3)
    return tuple(to_int16(b32 + _sext((v >> s) & 0xF, 4))
                 for s in (0, 4, 8, 12))
