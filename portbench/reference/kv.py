"""The plain reference of the CRAM-KV tier cells, in plain torch,
importing nothing of the program: decode attention over a session's raw
KV stream, and the CRAM layout the stream must take, worked out from the
raw bf16 bits by the paper's pair rule.

Layout: a session's tokens fill pages of `page` rows and groups of two
pages from token 0; a row is the bf16 bit patterns of K || V over the KV
heads.  A group packs 2:1 when every element of both pages lies within
[-128, 127] of the group's base row (its first token's row), compared
as signed 16-bit integers; rows not yet written are zero.  A live group
(one holding a token) costs one slot and its strip when packed, and a
slot and a strip for each live page when raw.  The cells run the
`dynamic` policy, whose gate starts on and is not re-sampled while they
serve, so a live group is packed exactly when it fits.

`control=True` computes the attention's products with the operands
rounded to TF32 (10 explicit mantissa bits), the precision below the
float32 the tier states for them."""

from __future__ import annotations

import math

import numpy as np
import torch

PAIR_LANES = 2
DELTA_LO, DELTA_HI = -128, 127


def kv_rows(k, v):
    """(T, Hkv, hd) bf16 K and V -> (T, Hkv * 2hd) int32 rows of signed
    16-bit bit patterns."""
    bits = torch.cat([k.view(torch.int16), v.view(torch.int16)], -1)
    return bits.reshape(bits.shape[0], -1).to(torch.int32)


def row_fits(rows, group_tokens: int):
    """-> (row_fit (T,) bool: each row lies within the delta range of its
    group's base row, zero_fit (G,) bool: a zero row would)."""
    t = rows.shape[0]
    g = -(-t // group_tokens)
    base = rows[::group_tokens]                              # (G, W)
    d = rows - base.repeat_interleave(group_tokens, 0)[:t]
    row_fit = ((d >= DELTA_LO) & (d <= DELTA_HI)).all(-1)
    zero_fit = ((-base >= DELTA_LO) & (-base <= DELTA_HI)).all(-1)
    assert zero_fit.shape[0] == g
    return row_fit, zero_fit


class Layout:
    """One session's layout as its length grows: `bytes(length)` is the
    layout's slot and strip bytes with `length` tokens in the cache."""

    def __init__(self, k, v, *, page: int, slot: int, strip: int):
        self.page, self.slot, self.strip = page, slot, strip
        self.span = PAIR_LANES * page
        rf, self.zero_fit = row_fits(kv_rows(k, v), self.span)
        t = rf.shape[0]
        pad = -t % self.span
        rf = torch.cat([rf, torch.ones(pad, dtype=torch.bool,
                                       device=rf.device)])
        # prefix_fit[g, f]: the first f + 1 rows of group g fit
        self.prefix_fit = (rf.reshape(-1, self.span).to(torch.int32)
                           .cumprod(1).bool().cpu().numpy())
        self.zero_fit = self.zero_fit.cpu().numpy()
        unit = slot + strip
        per_group = np.where(self.prefix_fit[:, -1], unit, PAIR_LANES * unit)
        self.complete_bytes = np.concatenate(
            [[0], np.cumsum(per_group, dtype=np.int64)])

    def bytes(self, length: int) -> int:
        done, fill = divmod(length, self.span)
        total = int(self.complete_bytes[done])
        if fill:
            unit = self.slot + self.strip
            if self.prefix_fit[done, fill - 1] and self.zero_fit[done]:
                total += unit
            else:
                total += -(-fill // self.page) * unit
        return total

    def raw_bytes(self, length: int) -> int:
        return -(-length // self.page) * self.slot


def _tf32(x):
    """float32 rounded to TF32's 10 explicit mantissa bits (nearest)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def attention(q, k, v, lengths, *, control: bool = False):
    """Decode attention of one session at several steps: q (S, Hq, hd)
    float32, k/v (T, Hkv, hd) bf16 (the raw stream), lengths (S,) valid
    tokens at each step -> (S, Hq, hd) float32."""
    s, hq, hd = q.shape
    t, hkv, _ = k.shape
    g = hq // hkv
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    qq = q.reshape(s, hkv, g, hd)
    if control:
        qq, kf, vf = _tf32(qq), _tf32(kf), _tf32(vf)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sc = torch.einsum("sjgd,tjd->sjgt", qq, kf) / math.sqrt(hd)
        valid = (torch.arange(t, device=q.device)[None, :]
                 < lengths[:, None].to(q.device))
        sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
        a = torch.softmax(sc, dim=-1)
        if control:
            a = _tf32(a)
        out = torch.einsum("sjgt,tjd->sjgd", a, vf)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out.reshape(s, hq, hd)
