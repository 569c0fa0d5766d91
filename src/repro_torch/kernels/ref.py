"""Plain-torch oracles for the kernels (port of `repro.kernels.ref`).

CRAM-KV layout (DESIGN.md §3):
  * a *slot* is the DMA unit: (page, Hkv, D2) int16, D2 = 2*head_dim (K||V)
  * each slot has a *strip*: (Hkv, D2+2) int16 = elementwise base row
    + the 4-byte marker in the last two int16 lanes (in-band metadata)
  * a PACKED slot holds `lanes` pages as int8 (pair) or int4 (quad)
    deltas against the strip base
  * marker values are per-slot (keyed hash)
"""

from __future__ import annotations

import torch

from ..compression import pagepack
from ..compression.framing import (  # noqa: F401  (re-exported for callers)
    MARKER_LANES,
    marker_to_lanes,
    slot_markers,
)

NEG_INF = -1e30


def pack_pair_ref(page_a, page_b):
    """-> (ok, packed (page,Hkv,D2) int16, base (Hkv, D2) int16)."""
    return pagepack.pack_pair(page_a, page_b)


def unpack_pair_ref(packed, base):
    return pagepack.unpack_pair(packed, base)


def pack_quad_ref(page_a, page_b, page_c, page_d):
    return pagepack.pack_quad(page_a, page_b, page_c, page_d)


def unpack_quad_ref(packed, base):
    return pagepack.unpack_quad(packed, base)


def strip_is_packed(strips: torch.Tensor, markers: torch.Tensor):
    """(..., n, Hkv, D2+2) strips vs (n,) expected markers -> (..., n) bool.

    The tail compare is done in int64 masked to 32 bits: the reference's
    int32 wraparound of `hi << 16` has no torch counterpart."""
    tail = strips[..., -MARKER_LANES:].to(torch.int64) & 0xFFFF
    tail_u = tail[..., 0] | (tail[..., 1] << 16)
    expected = markers.to(torch.int64) & 0xFFFFFFFF
    return (tail_u == expected.unsqueeze(-1)).all(-1)


def decode_slots(slots, strips, is_packed, lanes: int):
    """(..., n, page, Hkv, D2) slots -> (..., n, lanes, page, Hkv, D2)
    logical pages: decoded deltas where packed, else the raw slot in lane
    0 and zero pages in the other lanes."""
    d2 = slots.shape[-1]
    base = strips[..., :d2]
    decoded = (pagepack.unpack_pair(slots, base) if lanes == 2
               else pagepack.unpack_quad(slots, base))
    sel = is_packed[..., None, None, None]
    zeros = torch.zeros_like(slots)
    return torch.stack([torch.where(sel, pg, slots if j == 0 else zeros)
                        for j, pg in enumerate(decoded)], dim=-4)


def bf16_bits_to_f32(x: torch.Tensor) -> torch.Tensor:
    """int16 bf16 bit patterns -> float32 values (exact)."""
    return ((x.to(torch.int32) & 0xFFFF) << 16).view(torch.float32)


def materialize_kv_ref(slots, strips, markers, lanes: int = 2):
    """Decode the physical cache (n_slots, page, Hkv, D2) into logical
    pages (lanes*n_slots, page, Hkv, D2) int16 + pages per slot.  A raw
    slot contributes its page at index lanes*s (the rest zeros); a packed
    slot contributes pages lanes*s .. lanes*s + lanes-1."""
    n_slots, page, hkv, d2 = slots.shape
    is_packed = strip_is_packed(strips, markers)
    pages = decode_slots(slots, strips, is_packed, lanes)
    n_pages = torch.where(is_packed, lanes, 1)
    return pages.reshape(lanes * n_slots, page, hkv, d2), n_pages


def cram_decode_attention_ref(q, slots, strips, markers, valid_tokens,
                              lanes: int = 2):
    """Oracle decode attention over the CRAM-packed cache.

    q: (Hq, D); valid_tokens: (lanes*n_slots,) valid count per logical
    page.  Returns (Hq, D) float32.  Masked scores are -1e30, not -inf:
    a query with no valid token gets the mean of V over the masked
    positions, as in the reference."""
    n_slots, page, hkv, d2 = slots.shape
    d = d2 // 2
    g = q.shape[0] // hkv
    pages, _ = materialize_kv_ref(slots, strips, markers, lanes)
    kv = bf16_bits_to_f32(pages)
    t = lanes * n_slots * page
    k = kv[..., :d].reshape(t, hkv, d)
    v = kv[..., d:].reshape(t, hkv, d)
    mask = (torch.arange(page, device=slots.device)[None, :]
            < valid_tokens[:, None]).reshape(t)
    kg = torch.repeat_interleave(k, g, dim=1)
    vg = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("hd,thd->ht", q.to(torch.float32), kg)
    s = s / torch.sqrt(torch.tensor(float(d)))
    s = torch.where(mask[None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("ht,thd->hd", p, vg)
