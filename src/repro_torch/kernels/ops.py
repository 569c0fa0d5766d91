"""Public wrappers around the CRAM-KV kernels (port of `repro.kernels.ops`).

`build_cram_cache` packs logical KV pages pairwise into physical slots
(raw when the pair does not fit), writing base strips + in-band markers;
`build_cram_cache_quad` is the 4:1 analogue.  `pack_window` /
`pack_quad_window` / `raw_window` / `raw_quad_window` (re)lay a gathered
window of dirty groups, batched over sequences; `layout_window` is the one
dispatch the repack, the megastep and the prefill share.
`decode_attention_fused` runs the batched decode kernel over the cache's
leaves in place and returns the attention output together with the
per-sequence (raw, cram) bytes the kernel measured; `decode_attention` /
`decode_attention_batched` / `decode_attention_quad_batched` are aliases
that drop the bytes.  `hbm_bytes_moved` is the standalone byte model the
kernel's byte output matches bit for bit.  `cram_decode_attention` (K6,
one sequence's physical view) is exported here as in the reference.

Every function here is batch-generic over leading axes (the reference's
`vmap`s become the batch dimension written out), and follows the device
of its tensors: the kernels run on CUDA tensors, their plain versions on
CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..compression.framing import DEFAULT_MARKER_KEY, DOMAIN_PAIR, DOMAIN_QUAD
from . import bdi_pack
from . import ref as _ref
from .cram_attention import (cram_decode_attention,  # noqa: F401  (K6)
                             cram_decode_attention_in_place,
                             slot_geometry_bytes)
from .ref import MARKER_LANES, marker_to_lanes, slot_markers


# ------------------------------------------------------------------ windows

def pack_window(a, b, marker_lanes, enabled):
    """(Re)pack a window of dirty page pairs: a/b (B, W, page, Hkv, D2)
    int16; marker_lanes (W, 2) int16; enabled (B,) bool.  Returns (slots,
    overflow, strips, layout_packed (B, W), fit (B, W))."""
    return bdi_pack.pack_window(torch.stack([a, b], dim=2).contiguous(),
                                marker_lanes.contiguous(), enabled)


def pack_quad_window(pages, marker_lanes, enabled):
    """(Re)pack a window of dirty page quads: pages (B, W, 4, page, Hkv,
    D2).  Returns (slots, overflow (B, W, 3, ...), strips, lay, fit)."""
    return bdi_pack.pack_window(pages.contiguous(), marker_lanes.contiguous(),
                                enabled)


def _raw_strips(bsz, w, hkv, d2, device):
    return torch.zeros((bsz, w, hkv, d2 + MARKER_LANES), dtype=torch.int16,
                       device=device)


def raw_window(a, b):
    """Raw layout for a window of pairs (`policy="off"`): never launches the
    pack kernel, strips zeroed, nothing packed, no fitness measured."""
    bsz, w = a.shape[:2]
    hkv, d2 = a.shape[-2:]
    none = torch.zeros((bsz, w), dtype=torch.bool, device=a.device)
    return a, b, _raw_strips(bsz, w, hkv, d2, a.device), none, none.clone()


def raw_quad_window(pages):
    """Raw layout for a window of quads (`policy="off"`)."""
    bsz, w = pages.shape[:2]
    hkv, d2 = pages.shape[-2:]
    none = torch.zeros((bsz, w), dtype=torch.bool, device=pages.device)
    return (pages[:, :, 0], pages[:, :, 1:],
            _raw_strips(bsz, w, hkv, d2, pages.device), none, none.clone())


def layout_window(win, marker_lanes, enabled, *, use_pack):
    """Dispatch one gathered window (B, W, lanes, page, Hkv, D2) to its
    layout: the pack kernel (pair or quad by `lanes`), or the raw layout
    for `use_pack=False`.  Returns (slots, overflow, strips, lay, fit)."""
    lanes = win.shape[2]
    assert lanes in (2, 4), lanes
    if not use_pack:
        return (raw_window(win[:, :, 0], win[:, :, 1]) if lanes == 2
                else raw_quad_window(win))
    return bdi_pack.pack_window(win.contiguous(), marker_lanes.contiguous(),
                                enabled)


# ----------------------------------------------------------- whole caches

def _build(pages, lanes: int, key: int, domain: int) -> dict:
    """Pack (lanes*n, page, Hkv, D2) pages as one window with the gate on
    (the reference's `_pack_all` / `_pack_all_quad`)."""
    nl, page, hkv, d2 = pages.shape
    assert nl % lanes == 0
    n = nl // lanes
    markers = slot_markers(n, key, domain=domain)
    mk_lanes = torch.from_numpy(marker_to_lanes(markers)).to(pages.device)
    win = pages.reshape(1, n, lanes, page, hkv, d2)
    enabled = torch.ones(1, dtype=torch.bool, device=pages.device)
    slots, over, strips, lay, _ = bdi_pack.pack_window(
        win.contiguous(), mk_lanes, enabled)
    return {
        "slots": slots[0],
        "slots_overflow": over[0],
        "strips": strips[0],
        "markers": torch.from_numpy(markers.view(np.int32).copy()).to(
            pages.device),
        "packed_mask": lay[0],
    }


def build_cram_cache(pages, *, key: int = DEFAULT_MARKER_KEY) -> dict:
    """Pack logical pages (2n, page, Hkv, D2) int16 pairwise into a CRAM
    cache: dict(slots, slots_overflow (page B of unpacked pairs), strips,
    markers (int32), packed_mask)."""
    return _build(pages, 2, key, DOMAIN_PAIR)


def build_cram_cache_quad(pages, *, key: int = DEFAULT_MARKER_KEY) -> dict:
    """The 4:1 analogue over page quads (int4-delta codec, quad-domain
    markers); slots_overflow is (n, 3, page, Hkv, D2)."""
    return _build(pages, 4, key, DOMAIN_QUAD)


# ---------------------------------------------------------- physical views

def physical_view(cache, valid_per_page):
    """Flatten a pair cache to the slot list the decode kernel walks:
    packed pair -> 1 slot holding 2 pages; raw pair -> 2 slots (A, B).
    Leading batch axes are kept.  Returns (slots, strips, markers,
    valid (..., 2n, 2))."""
    slots, over = cache["slots"], cache["slots_overflow"]
    strips, markers, ok = (cache["strips"], cache["markers"],
                           cache["packed_mask"])
    lead = slots.shape[:-4]
    n, page, hkv, d2 = slots.shape[-4:]
    vp = valid_per_page.reshape(*lead, n, 2)
    all_slots = torch.stack([slots, over], -4).reshape(
        *lead, 2 * n, page, hkv, d2)
    all_strips = torch.stack([strips, torch.zeros_like(strips)], -3).reshape(
        *lead, 2 * n, hkv, d2 + MARKER_LANES)
    all_markers = torch.stack([markers, markers], 1).reshape(2 * n)
    zero = torch.zeros_like(vp[..., 0])
    okv = ok[..., None]
    va = torch.where(okv, vp, torch.stack([vp[..., 0], zero], -1))
    vb = torch.where(okv, torch.zeros_like(vp),
                     torch.stack([vp[..., 1], zero], -1))
    valid = torch.stack([va, vb], -2).reshape(*lead, 2 * n, 2)
    return all_slots, all_strips, all_markers, valid


def physical_view_quad(cache, valid_per_page):
    """Quad analogue: packed group -> 1 slot holding 4 pages; raw group ->
    4 slots (lead + 3 overflow).  Returns (slots, strips, markers,
    valid (..., 4n, 4))."""
    slots, over = cache["slots"], cache["slots_overflow"]
    strips, markers, ok = (cache["strips"], cache["markers"],
                           cache["packed_mask"])
    lead = slots.shape[:-4]
    n, page, hkv, d2 = slots.shape[-4:]
    vp = valid_per_page.reshape(*lead, n, 4)
    all_slots = torch.cat([slots.unsqueeze(-4), over], -4).reshape(
        *lead, 4 * n, page, hkv, d2)
    z = torch.zeros_like(strips)
    all_strips = torch.stack([strips, z, z, z], -3).reshape(
        *lead, 4 * n, hkv, d2 + MARKER_LANES)
    all_markers = torch.repeat_interleave(markers, 4)
    zero = torch.zeros_like(vp[..., 0])
    okv = ok[..., None]
    v_lead = torch.where(okv, vp, torch.stack([vp[..., 0], zero, zero, zero],
                                              -1))
    v_over = [torch.where(okv, torch.zeros_like(vp),
                          torch.stack([vp[..., j + 1], zero, zero, zero], -1))
              for j in range(3)]
    valid = torch.stack([v_lead, *v_over], -2).reshape(*lead, 4 * n, 4)
    return all_slots, all_strips, all_markers, valid


# ------------------------------------------------------------------ decode

def decode_attention_fused(q, cache, valid_per_page, predictor=None, *,
                           lanes: int = 2, block_groups: int | None = None):
    """The serve decode step: batched attention over the cache's leaves,
    read in place, plus the per-sequence bytes moved.

    q (B, Hq, D); cache leaves carry a leading batch axis (per-sequence
    caches) or none (one shared cache walked by every query row) except
    `markers`, which is always shared; valid_per_page (B?, lanes * n);
    `predictor` (B?, n) predicted group packedness, None for a perfect
    predictor.  Returns (out (B, Hq, D) float32, raw (B,) int32,
    cram (B,) int32), the bits of K3 over `physical_view`."""
    pred = cache["packed_mask"] if predictor is None else predictor
    with obs.span("cache.k3"):
        out, byts = cram_decode_attention_in_place(
            q, cache, valid_per_page, pred, lanes=lanes,
            block_groups=block_groups)
    return out, byts[:, 0], byts[:, 1]


def decode_attention(q, cache, valid_per_page):
    """q (B, Hq, D) over ONE shared pair cache -> (B, Hq, D) float32."""
    return decode_attention_fused(q, cache, valid_per_page, lanes=2)[0]


def decode_attention_batched(q, cache, valid_per_page):
    """Per-sequence pair caches -> (B, Hq, D) float32 (bytes dropped)."""
    return decode_attention_fused(q, cache, valid_per_page, lanes=2)[0]


def decode_attention_quad_batched(q, cache, valid_per_page):
    """Per-sequence quad caches -> (B, Hq, D) float32 (bytes dropped)."""
    return decode_attention_fused(q, cache, valid_per_page, lanes=4)[0]


def _ref_batched(q, cache, valid_per_page, lanes):
    pv = physical_view if lanes == 2 else physical_view_quad
    markers_u = cache["markers"]
    mk = (torch.stack([markers_u, markers_u], 1).reshape(-1) if lanes == 2
          else torch.repeat_interleave(markers_u, 4))
    outs = []
    for i in range(q.shape[0]):
        c = {k: (v if k == "markers" else v[i]) for k, v in cache.items()}
        s, st, _, v = pv(c, valid_per_page[i])
        outs.append(_ref.cram_decode_attention_ref(
            q[i], s, st, mk, v.reshape(-1), lanes=lanes))
    return torch.stack(outs)


def decode_attention_ref(q, cache, valid_per_page):
    """Oracle (plain torch) over one shared pair cache."""
    slots, strips, markers, valid = physical_view(cache, valid_per_page)
    return torch.stack([_ref.cram_decode_attention_ref(
        qi, slots, strips, markers, valid.reshape(-1)) for qi in q])


def decode_attention_ref_batched(q, cache, valid_per_page):
    """Oracle counterpart of decode_attention_batched."""
    return _ref_batched(q, cache, valid_per_page, 2)


def decode_attention_quad_ref_batched(q, cache, valid_per_page):
    """Oracle counterpart of decode_attention_quad_batched."""
    return _ref_batched(q, cache, valid_per_page, 4)


# ------------------------------------------------------------------ bytes

def hbm_bytes_moved_device(cache, valid_per_page, predictor=None,
                           lanes: int = 2):
    """Per-sequence (raw, cram) int32 byte tensors (scalars when unbatched)
    a decode step moves, with no host sync.  Group model: a packed group
    costs one slot + strip, an unpacked group one slot + strip per live
    page, a mispredicted live group one extra slot (the LLP re-probe)."""
    slot_bytes, strip_bytes = slot_geometry_bytes(*cache["slots"].shape[-3:])
    ok = cache["packed_mask"]
    v = valid_per_page.reshape(*ok.shape, lanes)
    pred = ok if predictor is None else predictor.to(torch.bool)
    live = v > 0
    n_live = live.sum(-1).to(torch.int64)
    raw = (n_live * slot_bytes).sum(-1)
    per_pair = torch.where(ok, torch.full_like(n_live, slot_bytes
                                               + strip_bytes),
                           n_live * (slot_bytes + strip_bytes))
    reprobe = (pred != ok).to(torch.int64) * slot_bytes
    cram = torch.where(live.any(-1), per_pair + reprobe,
                       torch.zeros_like(per_pair)).sum(-1)
    return raw.to(torch.int32), cram.to(torch.int32)


def hbm_bytes_moved(cache, valid_per_page, predictor=None,
                    lanes: int = 2) -> dict:
    """Bandwidth accounting as host numbers: bytes a decode step DMAs with
    and without CRAM, summed over the batch, plus the per-sequence
    columns."""
    raw, cram = hbm_bytes_moved_device(cache, valid_per_page, predictor,
                                       lanes)
    with obs.d2h(2):
        raw_h, cram_h = raw.cpu().numpy(), cram.cpu().numpy()
    raw_i = int(raw_h.sum(dtype=np.int64))
    cram_i = int(cram_h.sum(dtype=np.int64))
    return {"raw_bytes": raw_i, "cram_bytes": cram_i,
            "raw_per_seq": raw_h, "cram_per_seq": cram_h,
            "saving": 1.0 - cram_i / max(raw_i, 1)}
