"""Bulk chunked-prefill packing: lay every group a prompt touches at once
(port of `repro.kernels.prefill_pack`).

A T-token prompt lands as one scatter; every page group it touches is
codec-tried, marker-framed and slot-placed by ONE window-pack launch (the
same K1/K2 kernel as the incremental path).  A partial tail page arrives
zero-padded in its group and fails the fit check, staying raw — exactly
what a token-by-token replay converges to.
"""

from __future__ import annotations

from .ops import layout_window


def prefill_pack(pages, idx, marker_lanes, enabled, *, lanes, page,
                 use_pack=True):
    """pages (B, max_tokens, Hkv, D2) int16 after the prompt scatter;
    idx (W,) int64 touched group columns, padded to a power of two by
    repeating a real column; marker_lanes (n_groups, 2) int16; enabled (B,)
    bool.  Returns `(slots, overflow, strips, lay, fit)` for the W columns,
    the `layout_window` contract."""
    b, max_tokens, hkv, d2 = pages.shape
    n_groups = max_tokens // (lanes * page)
    groups = pages.reshape(b, n_groups, lanes, page, hkv, d2)
    return layout_window(groups[:, idx], marker_lanes[idx], enabled,
                         use_pack=use_pack)
