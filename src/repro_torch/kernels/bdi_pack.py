"""K1 / K2: the window pack (pair int8-delta 2:1, quad int4-delta 4:1),
and the page codecs' device pair: group pack (K1 / K2) and unpack (K4 / K5).

`pack_window` ports `repro.kernels.bdi_pack.pack_pair` / `pack_quad`
together with the (B, W) vmap and framing of `repro.kernels.ops.
pack_window` / `pack_quad_window`: one call lays a whole gathered window
(two launches over chunks of every group, `window_chunks`);
`pack_window_plain` is its plain PyTorch version.

`pack_pair` / `pack_quad` / `unpack_pair` / `unpack_quad` are the
registry's device backends of the int8-delta and int4-delta codecs
(`compression/codecs.py`), with the reference's return conventions:
pack -> (packed, base, ok), the truncated deltas written whatever ok says;
unpack -> the tuple of pages.  Any leading axes are a group axis walked in
one launch (the reference batches the single-group kernel with a vmap);
the pack runs each group as a thread-block cluster (`group_cluster`).
Their plain versions are `compression.pagepack`'s.

The CUDA kernels are in `csrc/bdi_pack.cu`.  Every entry dispatches on the
tensor's device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises.  There is no fallback between the two.
"""

from __future__ import annotations

import functools
import math

import torch

from ..compression import pagepack
from ..compression.framing import MARKER_LANES
from . import cuda_lib

# threads of a window-pack CTA (WINDOW_THREADS in csrc/bdi_pack.cu) and the
# CTAs per SM `window_chunks` aims at (16 of 64 threads: one wave)
WINDOW_THREADS = 64
WINDOW_CTAS_PER_SM = 16
# threads of a group-pack CTA (PACK_THREADS) and the largest cluster
# (MAX_CLUSTER, the portable size), both as in csrc/bdi_pack.cu
PACK_THREADS = 256
MAX_CLUSTER = 8

# kernel launches, by kernel; only the CUDA path counts
LAUNCHES = {"pack_pair": 0, "pack_quad": 0, "pack_pair_group": 0,
            "pack_quad_group": 0, "unpack_pair": 0, "unpack_quad": 0}


def pack_window_plain(win, marker_lanes, enabled):
    """win (B, W, lanes, page, Hkv, D2) int16; marker_lanes (W, 2) int16;
    enabled (B,) bool -> (slots, overflow, strips, lay, fit).

    Fit is measured whatever the gate says; the layout honours the gate:
    a disabled sequence gets the raw layout and all-zero strips, and the
    marker tail is written only where the group is laid packed."""
    bsz, w, lanes, _, hkv, d2 = win.shape
    pages = [win[:, :, j] for j in range(lanes)]
    pack = pagepack.pack_pair if lanes == 2 else pagepack.pack_quad
    fit, packed, base = pack(*pages)
    lay = fit & enabled[:, None]
    sel = lay[..., None, None, None]
    slots = torch.where(sel, packed, pages[0])
    over = pages[1] if lanes == 2 else win[:, :, 1:]
    over_sel = sel if lanes == 2 else sel[..., None]
    over = torch.where(over_sel, torch.zeros_like(over), over)
    strips = torch.zeros((bsz, w, hkv, d2 + MARKER_LANES), dtype=torch.int16,
                         device=win.device)
    strips[..., :d2] = base
    tail = marker_lanes[None, :, None, :].expand(bsz, w, hkv, MARKER_LANES)
    strips[..., d2:] = torch.where(lay[..., None, None], tail,
                                   torch.zeros_like(tail))
    strips = torch.where(enabled[:, None, None, None], strips,
                         torch.zeros_like(strips))
    return slots, over, strips, lay, fit


def _check(t, name, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def window_chunks(groups: int, nvec: int, sms: int) -> tuple[int, int]:
    """(vectors per chunk, chunks per group) of the window pack for
    `groups` page groups of `nvec` 16-byte vectors on a card of `sms` SMs:
    chunks of at least one vector per thread, sized so that the window
    fills about WINDOW_CTAS_PER_SM CTAs per SM (one wave); the last chunk
    of a group may be shorter."""
    per_cta = -(-groups * nvec // (WINDOW_CTAS_PER_SM * sms))
    chunk_vecs = min(nvec, max(WINDOW_THREADS, per_cta))
    return chunk_vecs, -(-nvec // chunk_vecs)


def group_cluster(groups: int, nvec: int, sms: int) -> tuple[int, int]:
    """(cluster size C, vectors per CTA) of the group pack for `groups`
    page groups of `nvec` 16-byte vectors on a card of `sms` SMs: C doubles
    from 1 up to MAX_CLUSTER while the call has fewer CTAs than SMs and
    each CTA keeps at least one vector per thread (more than one CTA per
    SM costs more to place than the spread wins: on the H100, 46 pair
    groups ran slower in clusters of 8 than of 4, and 1,024 groups slowest
    in clusters of 8); rank r of a group's cluster packs its vectors
    [r * chunk, (r + 1) * chunk), the last rank's cut at nvec."""
    cluster = 1
    while (cluster < MAX_CLUSTER and groups * cluster < sms
           and -(-nvec // (2 * cluster)) >= PACK_THREADS):
        cluster *= 2
    return cluster, -(-nvec // cluster)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def pack_window_cuda(win, marker_lanes, enabled):
    """The CUDA kernel on the same contract as `pack_window_plain`."""
    bsz, w, lanes, page, hkv, d2 = win.shape
    if lanes not in (2, 4):
        raise ValueError(f"lanes must be 2 or 4, got {lanes}")
    if d2 % 8:
        raise ValueError(f"D2={d2} must be a multiple of 8 (16-byte vectors)")
    _check(win, "win", torch.int16, win.shape)
    _check(marker_lanes, "marker_lanes", torch.int16, (w, MARKER_LANES))
    _check(enabled, "enabled", torch.bool, (bsz,))
    if win.data_ptr() % 16:
        raise ValueError("win must be 16-byte aligned (16-byte vector loads)")
    dev = win.device
    slots = torch.empty((bsz, w, page, hkv, d2), dtype=torch.int16, device=dev)
    over_shape = ((bsz, w, page, hkv, d2) if lanes == 2
                  else (bsz, w, lanes - 1, page, hkv, d2))
    over = torch.empty(over_shape, dtype=torch.int16, device=dev)
    strips = torch.empty((bsz, w, hkv, d2 + MARKER_LANES), dtype=torch.int16,
                         device=dev)
    lay = torch.empty((bsz, w), dtype=torch.bool, device=dev)
    fit = torch.empty((bsz, w), dtype=torch.bool, device=dev)
    nvec = page * hkv * d2 // 8
    if bsz * w * nvec == 0:
        return slots, over, strips, lay, fit
    chunk_vecs, chunks = window_chunks(bsz * w, nvec, _sm_count(dev))
    flags = torch.empty((bsz * w * chunks,), dtype=torch.uint8, device=dev)
    p = cuda_lib.ptr
    code = cuda_lib.load().cram_layout_window(
        p(win), p(marker_lanes), p(enabled), bsz, w, lanes, page, hkv, d2,
        chunk_vecs, chunks, p(flags), p(slots), p(over), p(strips), p(lay),
        p(fit), cuda_lib.stream_ptr(win))
    cuda_lib.check(code, "cram_layout_window")
    LAUNCHES["pack_pair" if lanes == 2 else "pack_quad"] += 1
    return slots, over, strips, lay, fit


@cuda_lib.kernel_wrapper(
    lambda win, *a: "pack_pair" if win.shape[2] == 2 else "pack_quad")
def pack_window(win, marker_lanes, enabled):
    """Lay a gathered window: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if win.device.type == "cpu":
        return pack_window_plain(win, marker_lanes, enabled)
    return pack_window_cuda(win, marker_lanes, enabled)


# ------------------------------------------------- the page codecs' device pair

def _groups(shape, name):
    """(leading shape, groups, page, hkv, d2) of a (..., page, Hkv, D2)
    tensor shape; D2 must fill 16-byte vectors."""
    if len(shape) < 3:
        raise ValueError(f"{name} must be (..., page, Hkv, D2), got {shape}")
    lead, (page, hkv, d2) = tuple(shape[:-3]), tuple(shape[-3:])
    if d2 % 8:
        raise ValueError(f"D2={d2} must be a multiple of 8 (16-byte vectors)")
    return lead, math.prod(lead), page, hkv, d2


def pack_pages_cuda(pages):
    """`lanes` (..., page, Hkv, D2) int16 CUDA pages -> (packed, base
    (..., Hkv, D2), ok (...) bool), deltas written whatever ok says; one
    launch, which writes every group's ok once."""
    lanes = len(pages)
    if lanes not in (2, 4):
        raise ValueError(f"a group is 2 or 4 pages, got {lanes}")
    lead, g, page, hkv, d2 = _groups(tuple(pages[0].shape), "pages")
    for i, pg in enumerate(pages):
        _check(pg, f"page {i}", torch.int16, pages[0].shape)
        if pg.data_ptr() % 16:
            raise ValueError(f"page {i} must be 16-byte aligned (16-byte "
                             "vector loads)")
    dev = pages[0].device
    packed = torch.empty(pages[0].shape, dtype=torch.int16, device=dev)
    base = torch.empty((*lead, hkv, d2), dtype=torch.int16, device=dev)
    nvec = page * hkv * d2 // 8
    if g * nvec == 0:     # nothing to read: every group fits, vacuously
        return packed, base, torch.full(lead, True, dtype=torch.bool,
                                        device=dev)
    cluster, chunk_vecs = group_cluster(g, nvec, _sm_count(dev))
    if g * cluster >= 2**31 or nvec > 2**30:
        raise ValueError(f"{g} groups of {nvec} vectors is beyond one launch")
    ok = torch.empty(lead, dtype=torch.bool, device=dev)
    p = cuda_lib.ptr
    quad = pages if lanes == 4 else (*pages, None, None)
    code = cuda_lib.load().cram_pack_pages(
        *(None if x is None else p(x) for x in quad), g, lanes, page, hkv, d2,
        cluster, chunk_vecs, p(packed), p(base), p(ok),
        cuda_lib.stream_ptr(packed))
    cuda_lib.check(code, "cram_pack_pages")
    LAUNCHES["pack_pair_group" if lanes == 2 else "pack_quad_group"] += 1
    return packed, base, ok


def unpack_pages_cuda(packed, base, lanes: int):
    """packed (..., page, Hkv, D2) int16 + base (..., Hkv, D2) on the card
    -> `lanes` (..., page, Hkv, D2) int16 pages."""
    if lanes not in (2, 4):
        raise ValueError(f"lanes must be 2 or 4, got {lanes}")
    lead, g, page, hkv, d2 = _groups(tuple(packed.shape), "packed")
    _check(packed, "packed", torch.int16, packed.shape)
    _check(base, "base", torch.int16, (*lead, hkv, d2))
    out = torch.empty((lanes, *packed.shape), dtype=torch.int16,
                      device=packed.device)
    if g * page * hkv * d2:
        p = cuda_lib.ptr
        code = cuda_lib.load().cram_unpack_pages(
            p(packed), p(base), g, lanes, page, hkv, d2, p(out),
            cuda_lib.stream_ptr(packed))
        cuda_lib.check(code, "cram_unpack_pages")
        LAUNCHES["unpack_pair" if lanes == 2 else "unpack_quad"] += 1
    return tuple(out.unbind(0))


@cuda_lib.kernel_wrapper("pack_pair_group")
def pack_pair(page_a, page_b):
    """Pair pack (K1, the int8-delta codec's device pack): -> (packed,
    base, ok)."""
    if page_a.device.type == "cpu":
        ok, packed, base = pagepack.pack_pair(page_a, page_b)
        return packed, base, ok
    return pack_pages_cuda((page_a, page_b))


@cuda_lib.kernel_wrapper("pack_quad_group")
def pack_quad(page_a, page_b, page_c, page_d):
    """Quad pack (K2, the int4-delta codec's device pack): -> (packed,
    base, ok)."""
    if page_a.device.type == "cpu":
        ok, packed, base = pagepack.pack_quad(page_a, page_b, page_c, page_d)
        return packed, base, ok
    return pack_pages_cuda((page_a, page_b, page_c, page_d))


@cuda_lib.kernel_wrapper("unpack_pair")
def unpack_pair(packed, base):
    """K4: inverse of pack_pair -> (page_a, page_b)."""
    if packed.device.type == "cpu":
        return pagepack.unpack_pair(packed, base)
    return unpack_pages_cuda(packed, base, 2)


@cuda_lib.kernel_wrapper("unpack_quad")
def unpack_quad(packed, base):
    """K5: inverse of pack_quad -> (page_a, page_b, page_c, page_d)."""
    if packed.device.type == "cpu":
        return pagepack.unpack_quad(packed, base)
    return unpack_pages_cuda(packed, base, 4)
