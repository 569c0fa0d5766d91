"""K1 / K2: the window pack (pair int8-delta 2:1, quad int4-delta 4:1).

Port of `repro.kernels.bdi_pack.pack_pair` / `pack_quad` together with
the (B, W) vmap and framing of `repro.kernels.ops.pack_window` /
`pack_quad_window`: one launch lays a whole gathered window.  The CUDA
kernel is `csrc/bdi_pack.cu`; `pack_window_plain` is the plain PyTorch
version of the same function.

`pack_window` dispatches on the tensor's device: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises.  There is no
fallback between the two.
"""

from __future__ import annotations

import torch

from ..compression import pagepack
from ..compression.framing import MARKER_LANES
from . import cuda_lib

# kernel launches, by kernel; only the CUDA path counts
LAUNCHES = {"pack_pair": 0, "pack_quad": 0}


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
    dev = win.device
    slots = torch.empty((bsz, w, page, hkv, d2), dtype=torch.int16, device=dev)
    over_shape = ((bsz, w, page, hkv, d2) if lanes == 2
                  else (bsz, w, lanes - 1, page, hkv, d2))
    over = torch.empty(over_shape, dtype=torch.int16, device=dev)
    strips = torch.empty((bsz, w, hkv, d2 + MARKER_LANES), dtype=torch.int16,
                         device=dev)
    lay = torch.empty((bsz, w), dtype=torch.bool, device=dev)
    fit = torch.empty((bsz, w), dtype=torch.bool, device=dev)
    if bsz * w == 0:
        return slots, over, strips, lay, fit
    p = cuda_lib.ptr
    code = cuda_lib.load().cram_layout_window(
        p(win), p(marker_lanes), p(enabled), bsz, w, lanes, page, hkv, d2,
        p(slots), p(over), p(strips), p(lay), p(fit),
        cuda_lib.stream_ptr(win))
    cuda_lib.check(code, "cram_layout_window")
    LAUNCHES["pack_pair" if lanes == 2 else "pack_quad"] += 1
    return slots, over, strips, lay, fit


def pack_window(win, marker_lanes, enabled):
    """Lay a gathered window: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors."""
    if win.device.type == "cpu":
        return pack_window_plain(win, marker_lanes, enabled)
    return pack_window_cuda(win, marker_lanes, enabled)
