"""K3: batched decode attention over the CRAM-packed paged cache, and K6:
the single-sequence decode.

K3 ports `repro.kernels.cram_attention.cram_decode_attention_batched`:
per flat slot, the strip-tail marker check (implicit metadata), the delta
decode of the packed pages, the split of bf16 K||V, GQA, the valid mask
and the softmax; the second output is the per-sequence (raw, cram) bytes
the step moves for exactly the layout walked, LLP re-probe included.

The CUDA kernel is `csrc/cram_attention.cu`;
`cram_decode_attention_batched_plain` is the plain PyTorch version (one
softmax pass over the whole sequence, as the reference's oracle).
`cram_decode_attention_batched` dispatches on the device of `q`: CPU runs
the plain version, CUDA launches the kernel or raises.

K6 ports `repro.kernels.cram_attention.cram_decode_attention` (one
sequence's `n` physical slots, any `n`, no predictor, no bytes); its CUDA
entry shares K3's device body, and its plain version is
`ref.cram_decode_attention_ref`, the reference's oracle, on the same
inputs.  It is the per-sequence parity reference for K3.

Both kernels cut a sequence's flat slots into splits of `split_width(n)`
slots, one CTA per (sequence, KV head, split) and chunk of at most 8 of
the KV head's query heads.  They take any whole GQA group and any
head_dim that is a multiple of 8 from 8 to 128.  The split width
depends on `n` alone, so K6 on a sequence and K3's row for it (with
`block_groups=None`) run the same splits and agree bit for bit, whatever
the batch.
"""

from __future__ import annotations

import math

import torch

from .ref import (MARKER_LANES, NEG_INF, bf16_bits_to_f32,
                  cram_decode_attention_ref, decode_slots, strip_is_packed)
from . import cuda_lib

# Default slot-block width (page groups per program) of the reference;
# `resolve_block_groups` keeps its meaning for an explicit `block_groups`.
DEFAULT_BLOCK_GROUPS = 4
# Most splits the kernels cut one sequence (and KV head) into.
MAX_SPLITS = 16

# kernel launches; only the CUDA path counts
LAUNCHES = {"decode_attention_pair": 0, "decode_attention_quad": 0,
            "decode_single_pair": 0, "decode_single_quad": 0}


def resolve_block_groups(n_groups: int, block_groups: int | None) -> int:
    """Largest divisor of `n_groups` not exceeding the requested width."""
    bg = DEFAULT_BLOCK_GROUPS if block_groups is None else block_groups
    bg = max(1, min(bg, n_groups))
    while n_groups % bg:
        bg -= 1
    return bg


def split_width(n: int) -> int:
    """Flat slots per split: the fewest that cut `n` slots into at most
    MAX_SPLITS runs; the last run may be shorter."""
    return -(-n // MAX_SPLITS)


def slot_geometry_bytes(page: int, hkv: int, d2: int) -> tuple[int, int]:
    """(slot_bytes, strip_bytes) of one physical slot and its strip."""
    return page * hkv * d2 * 2, hkv * (d2 + MARKER_LANES) * 2


def bytes_moved_flat(is_packed, valid, predictor, *, lanes, slot_bytes,
                     strip_bytes):
    """Per-sequence (raw, cram) int32 bytes in the flat-slot form the kernel
    uses: the lead slot of a packed group carries all `lanes` valid counts,
    a raw group spreads one live page per slot; a mispredicted live group
    costs one re-probe slot, judged by the lead slot's marker verdict.

    is_packed (B, n) bool; valid (B, n, lanes); predictor (B, n//lanes)."""
    b, n = is_packed.shape
    live = valid > 0
    n_live = live.sum(-1).to(torch.int64)
    raw = n_live.sum(-1) * slot_bytes
    per_slot = torch.where(is_packed & (n_live > 0),
                           torch.full_like(n_live, slot_bytes + strip_bytes),
                           n_live * (slot_bytes + strip_bytes))
    grp_packed = is_packed.reshape(b, n // lanes, lanes)[..., 0]
    grp_live = live.reshape(b, n // lanes, lanes * lanes).any(-1)
    reprobe = ((predictor != 0) != grp_packed) & grp_live
    cram = per_slot.sum(-1) + reprobe.to(torch.int64).sum(-1) * slot_bytes
    return torch.stack([raw, cram], -1).to(torch.int32)


def _batch(x, b, shared_cache):
    return x.unsqueeze(0).expand(b, *x.shape) if shared_cache else x


def cram_decode_attention_batched_plain(q, slots, strips, markers, valid,
                                        predictor, *, lanes: int = 2,
                                        block_groups: int | None = None,
                                        shared_cache: bool = False):
    """Plain version.  `block_groups` (the kernel's split width in page
    groups; None for `split_width`) only orders the kernel's float sums, so
    the one-pass softmax here ignores it (kept for the same signature).
    Each query row is its own products, so a row's result does not depend
    on B: a slot shard gives the bits of the whole batch's call."""
    del block_groups
    b, hq, d = q.shape
    slots = _batch(slots, b, shared_cache)
    strips = _batch(strips, b, shared_cache)
    valid = _batch(valid, b, shared_cache)
    predictor = _batch(predictor, b, shared_cache)
    _, n, page, hkv, d2 = slots.shape
    slot_bytes, strip_bytes = slot_geometry_bytes(page, hkv, d2)
    is_packed = strip_is_packed(strips, markers)
    kv = bf16_bits_to_f32(decode_slots(slots, strips, is_packed, lanes))
    t = n * lanes * page
    k = kv[..., :d].reshape(b, t, hkv, d)
    v = kv[..., d:].reshape(b, t, hkv, d)
    tok = torch.arange(page, device=slots.device)
    mask = (tok < valid[..., None]).reshape(b, t)
    g = hq // hkv
    kg = torch.repeat_interleave(k, g, dim=2)
    vg = torch.repeat_interleave(v, g, dim=2)
    qf = q.to(torch.float32)
    out = q.new_empty((b, hq, d), dtype=torch.float32)
    for i in range(b):
        s = torch.einsum("hd,thd->ht", qf[i], kg[i]) * (1.0 / math.sqrt(d))
        p = torch.softmax(torch.where(mask[i, None, :], s, NEG_INF), dim=-1)
        out[i] = torch.einsum("ht,thd->hd", p, vg[i])
    byts = bytes_moved_flat(is_packed, valid, predictor, lanes=lanes,
                            slot_bytes=slot_bytes, strip_bytes=strip_bytes)
    return out, byts


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_geometry(lanes, hq, d, hkv, d2):
    """What the kernels take: any whole GQA group, and a head_dim that is a
    multiple of 8 (16-byte row copies) from 8 to 128 (a CTA pads it to
    whole warps of at most four columns a thread)."""
    _require(lanes in (2, 4), f"lanes must be 2 or 4, got {lanes}")
    _require(d2 == 2 * d, f"slots D2={d2} != 2 * head_dim {d}")
    _require(hkv > 0 and hq > 0 and hq % hkv == 0,
             f"Hq={hq} is not a whole number of groups of Hkv={hkv}")
    _require(d % 8 == 0 and 8 <= d <= 128, f"head_dim {d}: the kernels "
             "take a multiple of 8 from 8 to 128")


def _check_tensors(q, expect: dict, nlead: int = 0) -> None:
    """Each of `expect`'s (tensor, dtype, shape) on q's device, of that
    type and shape, contiguous past its first `nlead` (0 or 1) axes, whose
    stride may be anything (a slice of a larger state, a row shard of
    one); q contiguous float32."""
    for name, (t, dtype, shape) in expect.items():
        _require(t.device == q.device, f"{name} is on {t.device}, "
                 f"q on {q.device}")
        _require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _require(tuple(t.shape) == shape,
                 f"{name} must have shape {shape}, got {tuple(t.shape)}")
        _require((t[0] if nlead else t).is_contiguous(),
                 f"{name} must be contiguous"
                 + (" past its batch axis" if nlead else ""))
    _require(q.dtype == torch.float32 and q.is_contiguous(),
             "q must be contiguous float32")


def _check_aligned(q, slots, strips) -> None:
    """The kernel reads q and stages slot rows with 16-byte loads, and
    strip rows with 4-byte ones."""
    _require(q.data_ptr() % 16 == 0, "q must be 16-byte aligned")
    _require(slots.data_ptr() % 16 == 0, "slots must be 16-byte aligned")
    _require(strips.data_ptr() % 4 == 0, "strips must be 4-byte aligned")


def cram_decode_attention_batched_cuda(q, slots, strips, markers, valid,
                                       predictor, *, lanes: int = 2,
                                       block_groups: int | None = None,
                                       shared_cache: bool = False):
    """The CUDA kernel on the same contract as the plain version."""
    b, hq, d = q.shape
    lead = () if shared_cache else (b,)
    _require(slots.dim() == len(lead) + 4, "slots rank does not match "
             "shared_cache")
    n, page, hkv, d2 = slots.shape[-4:]
    _check_geometry(lanes, hq, d, hkv, d2)
    _require(n % lanes == 0, f"flat slot count {n} not a multiple of {lanes}")
    _check_tensors(q, {
        "slots": (slots, torch.int16, lead + (n, page, hkv, d2)),
        "strips": (strips, torch.int16, lead + (n, hkv, d2 + MARKER_LANES)),
        "markers": (markers, torch.int32, (n,)),
        "valid": (valid, torch.int32, lead + (n, lanes)),
        "predictor": (predictor, torch.int32, lead + (n // lanes,)),
    })
    _check_aligned(q, slots, strips)
    kk = (split_width(n) if block_groups is None
          else resolve_block_groups(n // lanes, block_groups) * lanes)
    nj = -(-n // kk)
    dev = q.device
    part_m = torch.empty((b, hq, nj), dtype=torch.float32, device=dev)
    part_l = torch.empty((b, hq, nj), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b, hq, nj, d), dtype=torch.float32, device=dev)
    part_bytes = torch.empty((b, nj, 2), dtype=torch.int32, device=dev)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    byts = torch.empty((b, 2), dtype=torch.int32, device=dev)
    slot_bytes, strip_bytes = slot_geometry_bytes(page, hkv, d2)
    p = cuda_lib.ptr
    code = cuda_lib.load().cram_decode_attention(
        p(q), p(slots), p(strips), p(markers), p(valid), p(predictor),
        b, hq, d, n, page, hkv, lanes, kk, int(shared_cache),
        1.0 / math.sqrt(d), slot_bytes, strip_bytes,
        p(part_m), p(part_l), p(part_acc), p(part_bytes), p(out), p(byts),
        cuda_lib.stream_ptr(q))
    cuda_lib.check(code, "cram_decode_attention")
    LAUNCHES["decode_attention_pair" if lanes == 2
             else "decode_attention_quad"] += 1
    return out, byts


@cuda_lib.kernel_wrapper(
    lambda *a, lanes=2, **kw: ("decode_attention_pair" if lanes == 2
                               else "decode_attention_quad"))
def cram_decode_attention_batched(q, slots, strips, markers, valid,
                                  predictor, *, lanes: int = 2,
                                  block_groups: int | None = None,
                                  shared_cache: bool = False):
    """Batched fused decode.

    q (B, Hq, D); slots (B, n, page, Hkv, D2) int16 — or (n, ...) with
    `shared_cache=True`; strips (B?, n, Hkv, D2+2); markers (n,) int32;
    valid (B?, n, lanes) int32; predictor (B?, n // lanes) int32.
    Returns (out (B, Hq, D) float32, bytes (B, 2) int32)."""
    kw = dict(lanes=lanes, block_groups=block_groups,
              shared_cache=shared_cache)
    if q.device.type == "cpu":
        return cram_decode_attention_batched_plain(
            q, slots, strips, markers, valid, predictor, **kw)
    return cram_decode_attention_batched_cuda(
        q.to(torch.float32).contiguous(), slots, strips, markers,
        valid.to(torch.int32).contiguous(),
        predictor.to(torch.int32).contiguous(), **kw)


# ------------------------------------------------------- K3 in place

def _lead(t, nlead: int) -> int:
    """Batch stride in elements of a leaf with `nlead` (0 or 1) batch
    axes: 0 for a shared leaf."""
    return t.stride(0) if nlead else 0


def _from_storage(leaf, off, width: int = 1):
    """The `width` elements at each element offset `off` from `leaf`'s
    first element, read from its storage as the kernel reads them (so a
    strided leaf is not made contiguous first): off.shape + (width,)."""
    flat = torch.as_strided(leaf, (int(off.max()) + width,), (1,))
    return flat[off[..., None] + torch.arange(width, device=leaf.device)]


def leaf_addresses(cache, valid_per_page, *, lanes: int = 2):
    """The plain counterpart of the in-place entry's addressing (LeafSlots
    in `csrc/cram_attention.cuh`), from the leaves and their strides as the
    kernel gets them.  For flat slot s = lanes * g + j of each cache row
    (one row for a shared cache, whose batch stride is 0): `src` 0 for
    `slots`, 1 for `slots_overflow`; `slot_off` the element offset of its
    page rows from that leaf's first element; `strip_off` the offset of
    its strip row in `strips`, -1 for the all-zero row of an overflow
    slot; `marker` the index into `markers` (g); `valid` its `lanes`
    counts, as `physical_view` lays them: a packed group's lead slot holds
    the group's counts and its overflow slots none, a raw group's slot j
    holds page j's count in its first lane.  Returns a dict of tensors of
    shapes (R, lanes * n) (int64) and (R, lanes * n, lanes) (valid, in
    valid_per_page's dtype)."""
    slots, over = cache["slots"], cache["slots_overflow"]
    strips, mask = cache["strips"], cache["packed_mask"]
    nlead = slots.dim() - 4
    n, page, hkv, d2 = slots.shape[-4:]
    rows = slots.shape[0] if nlead else 1
    slot_elems, strip_elems = page * hkv * d2, hkv * (d2 + MARKER_LANES)
    dev = slots.device
    s = torch.arange(lanes * n, device=dev)
    g, j = s // lanes, s % lanes
    b = torch.arange(rows, device=dev)[:, None]
    lead = j == 0
    src = (~lead).to(torch.int64).expand(rows, -1)
    slot_off = torch.where(
        lead, b * _lead(slots, nlead) + g * slot_elems,
        b * _lead(over, nlead) + (g * (lanes - 1) + j - 1) * slot_elems)
    strip_off = torch.where(lead, b * _lead(strips, nlead) + g * strip_elems,
                            torch.full_like(slot_off, -1))
    vrow = b * _lead(valid_per_page, nlead) + g * lanes
    ok = _from_storage(mask, b * _lead(mask, nlead) + g)
    own = _from_storage(valid_per_page, vrow, lanes)
    first = _from_storage(valid_per_page, vrow + j)
    q = torch.arange(lanes, device=dev)
    valid = torch.where(ok, torch.where(lead[:, None], own, 0),
                        torch.where(q == 0, first, 0))
    return {"src": src, "slot_off": slot_off, "strip_off": strip_off,
            "marker": g, "valid": valid}


def leaf_view(cache, valid_per_page, *, lanes: int = 2):
    """The flat slot view K3's in-place entry walks, read from the leaves'
    storage at `leaf_addresses`' offsets: (slots, strips, markers, valid)
    of `physical_view`'s shapes, element for element what the kernel
    reads for each flat slot."""
    a = leaf_addresses(cache, valid_per_page, lanes=lanes)
    slots, over = cache["slots"], cache["slots_overflow"]
    strips = cache["strips"]
    nlead = slots.dim() - 4
    n, page, hkv, d2 = slots.shape[-4:]
    slot_elems = page * hkv * d2
    lead = a["src"] == 0
    got = torch.where(
        lead[..., None],
        _from_storage(slots, torch.where(lead, a["slot_off"], 0), slot_elems),
        _from_storage(over, torch.where(lead, 0, a["slot_off"]), slot_elems))
    zero = a["strip_off"] < 0
    st = torch.where(zero[..., None], 0, _from_storage(
        strips, a["strip_off"].clamp(min=0), hkv * (d2 + MARKER_LANES)))
    out = (got.reshape(-1, lanes * n, page, hkv, d2),
           st.reshape(-1, lanes * n, hkv, d2 + MARKER_LANES),
           cache["markers"][a["marker"]], a["valid"])
    if not nlead:
        out = (out[0][0], out[1][0], out[2], out[3][0])
    return out


def cram_decode_attention_in_place_plain(q, cache, valid_per_page,
                                         predictor, *, lanes: int = 2,
                                         block_groups: int | None = None):
    """Plain version of the in-place entry: the flat plain version over
    `leaf_view`."""
    slots, strips, markers, valid = leaf_view(cache, valid_per_page,
                                              lanes=lanes)
    return cram_decode_attention_batched_plain(
        q, slots, strips, markers, valid, predictor, lanes=lanes,
        block_groups=block_groups,
        shared_cache=cache["slots"].dim() == 4)


def cram_decode_attention_in_place_cuda(q, cache, valid_per_page, predictor,
                                        *, lanes: int = 2,
                                        block_groups: int | None = None):
    """The CUDA kernel on the same contract as
    `cram_decode_attention_in_place_plain`: valid_per_page int32 and
    predictor bool, each leaf contiguous past its batch axis."""
    b, hq, d = q.shape
    slots, over = cache["slots"], cache["slots_overflow"]
    strips, markers = cache["strips"], cache["markers"]
    mask = cache["packed_mask"]
    nlead = slots.dim() - 4
    _require(nlead in (0, 1), "slots must be (B?, n, page, Hkv, D2)")
    lead = (b,) if nlead else ()
    n, page, hkv, d2 = slots.shape[-4:]
    _check_geometry(lanes, hq, d, hkv, d2)
    _require(n > 0, "the cache needs at least one group")
    ov = (n, page, hkv, d2) if lanes == 2 else (n, lanes - 1, page, hkv, d2)
    _check_tensors(q, {
        "slots": (slots, torch.int16, lead + (n, page, hkv, d2)),
        "slots_overflow": (over, torch.int16, lead + ov),
        "strips": (strips, torch.int16, lead + (n, hkv, d2 + MARKER_LANES)),
        "packed_mask": (mask, torch.bool, lead + (n,)),
        "valid_per_page": (valid_per_page, torch.int32, lead + (lanes * n,)),
        "predictor": (predictor, torch.bool, lead + (n,)),
    }, nlead)
    _check_tensors(q, {"markers": (markers, torch.int32, (n,))})
    _check_aligned(q, slots, strips)
    sb = [_lead(t, nlead) for t in (slots, over, strips, mask,
                                    valid_per_page, predictor)]
    _require(over.data_ptr() % 16 == 0 and sb[0] % 8 == 0 and sb[1] % 8 == 0
             and sb[2] % 2 == 0, "the slot leaves' batch strides must keep "
             "16-byte rows, the strips' 4-byte ones")
    nf = lanes * n
    kk = (split_width(nf) if block_groups is None
          else resolve_block_groups(n, block_groups) * lanes)
    nj = -(-nf // kk)
    dev = q.device
    part_m = torch.empty((b, hq, nj), dtype=torch.float32, device=dev)
    part_l = torch.empty((b, hq, nj), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b, hq, nj, d), dtype=torch.float32, device=dev)
    part_bytes = torch.empty((b, nj, 2), dtype=torch.int32, device=dev)
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    byts = torch.empty((b, 2), dtype=torch.int32, device=dev)
    slot_bytes, strip_bytes = slot_geometry_bytes(page, hkv, d2)
    p = cuda_lib.ptr
    code = cuda_lib.load().cram_decode_attention_leaves(
        p(q), p(slots), p(over), p(strips), p(markers), p(mask),
        p(valid_per_page), p(predictor), *sb, b, hq, d, n, page, hkv, lanes,
        kk, 1.0 / math.sqrt(d), slot_bytes, strip_bytes, p(part_m),
        p(part_l), p(part_acc), p(part_bytes), p(out), p(byts),
        cuda_lib.stream_ptr(q))
    cuda_lib.check(code, "cram_decode_attention_leaves")
    LAUNCHES["decode_attention_pair" if lanes == 2
             else "decode_attention_quad"] += 1
    return out, byts


@cuda_lib.kernel_wrapper(
    lambda *a, lanes=2, **kw: ("decode_attention_pair" if lanes == 2
                               else "decode_attention_quad"))
def cram_decode_attention_in_place(q, cache, valid_per_page, predictor, *,
                                   lanes: int = 2,
                                   block_groups: int | None = None):
    """K3 over a cache state's own leaves, read in place: q (B, Hq, D);
    `cache` the dict of `kv.cache.kernel_cache_slice` (slots, slots_overflow,
    strips, packed_mask with a leading batch axis, or none for a shared
    cache; markers (n,) int32), each leaf contiguous past its batch axis,
    whose stride may be anything (a slice `[:, :n]` of a larger state, a
    row shard of one); valid_per_page (B?, lanes * n) integer; predictor
    (B?, n) bool or integer.  Returns what `cram_decode_attention_batched`
    returns on `physical_view` of the same cache, bit for bit, without
    building it."""
    kw = dict(lanes=lanes, block_groups=block_groups)
    if q.device.type == "cpu":
        return cram_decode_attention_in_place_plain(
            q, cache, valid_per_page, predictor, **kw)
    return cram_decode_attention_in_place_cuda(
        q.to(torch.float32).contiguous(), cache,
        valid_per_page.to(torch.int32), predictor.to(torch.bool), **kw)


# ------------------------------------------------------------------ K6

def cram_decode_attention_plain(q, slots, strips, markers, valid, *,
                                lanes: int = 2):
    """Plain version of K6: the reference's oracle on the same inputs."""
    return cram_decode_attention_ref(q, slots, strips, markers,
                                     valid.reshape(-1), lanes=lanes)


def cram_decode_attention_cuda(q, slots, strips, markers, valid, *,
                               lanes: int = 2):
    """The CUDA kernel (K6) on the same contract as the plain version."""
    hq, d = q.shape
    _require(slots.dim() == 4, "slots must be (n, page, Hkv, D2)")
    n, page, hkv, d2 = slots.shape
    _require(n > 0, "a sequence needs at least one slot")
    _check_geometry(lanes, hq, d, hkv, d2)
    _check_tensors(q, {
        "slots": (slots, torch.int16, (n, page, hkv, d2)),
        "strips": (strips, torch.int16, (n, hkv, d2 + MARKER_LANES)),
        "markers": (markers, torch.int32, (n,)),
        "valid": (valid, torch.int32, (n, lanes)),
    })
    _check_aligned(q, slots, strips)
    kk = split_width(n)
    nj = -(-n // kk)
    dev = q.device
    part_m = torch.empty((hq, nj), dtype=torch.float32, device=dev)
    part_l = torch.empty((hq, nj), dtype=torch.float32, device=dev)
    part_acc = torch.empty((hq, nj, d), dtype=torch.float32, device=dev)
    out = torch.empty((hq, d), dtype=torch.float32, device=dev)
    p = cuda_lib.ptr
    code = cuda_lib.load().cram_decode_attention_single(
        p(q), p(slots), p(strips), p(markers), p(valid), hq, d, n, page, hkv,
        lanes, kk, 1.0 / math.sqrt(d), p(part_m), p(part_l), p(part_acc),
        p(out), cuda_lib.stream_ptr(q))
    cuda_lib.check(code, "cram_decode_attention_single")
    LAUNCHES["decode_single_pair" if lanes == 2 else "decode_single_quad"] += 1
    return out


@cuda_lib.kernel_wrapper(
    lambda *a, lanes=2, **kw: ("decode_single_pair" if lanes == 2
                               else "decode_single_quad"))
def cram_decode_attention(q, slots, strips, markers, valid, *,
                          lanes: int = 2):
    """Single-sequence fused decode.

    q (Hq, D); slots (n, page, Hkv, D2) int16; strips (n, Hkv, D2+2) int16;
    markers (n,) int32 expected pack markers; valid (n, lanes) int32 valid
    tokens per logical page.  `lanes` selects the slot format: 2 = pair
    (int8-delta), 4 = quad (int4-delta).  Returns (Hq, D) float32."""
    if q.device.type == "cpu":
        return cram_decode_attention_plain(q, slots, strips, markers, valid,
                                           lanes=lanes)
    return cram_decode_attention_cuda(
        q.to(torch.float32).contiguous(), slots, strips, markers,
        valid.to(torch.int32).contiguous(), lanes=lanes)
