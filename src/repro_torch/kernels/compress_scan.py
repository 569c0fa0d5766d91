"""K7: one-pass compressibility scan of a whole memory image.

Port of `repro.kernels.compress_scan`.  For every 64-byte line of an image,
in one launch:
  * the hybrid FPC+BDI compressed size (header byte included) — the same
    quantity as `compression.hybrid.compressed_sizes`, the bit-true numpy
    codec;
  * the FPC size and the best BDI payload on their own;
  * the implicit-metadata marker class of the line against its slot's
    device marker family (COMP2 / COMP4 / INVALID / MAYBE_INVERTED /
    UNCOMP, `compression.marker.LineStatus`).  Line i lives in slot i.

The CUDA kernel is `csrc/compress_scan.cu`; `compress_scan_plain` is the
plain PyTorch version of the kernel body.  `compress_scan` dispatches on
the tensor's device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel or raises.

The device marker family is a multiply-add keyed hash that wraps mod
2^32: the reference computes it in int32 on the TPU and in uint32 on the
host (`device_markers`, `device_il_words`, `classify_image_ref` below);
the kernel computes it in uint32, the plain version in int64 masked to
32 bits with products split so that nothing overflows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compression.framing import (DEFAULT_MARKER_KEY, HEADER_BYTES,
                                   IL_MULT, LINE_BYTES, M2_MULT, M4_MULT)
from ..compression.marker import LineStatus
from . import cuda_lib

WORDS_PER_LINE = 16

# BDI modes as (base_bytes, delta_bytes, payload_bytes), evaluated from the
# largest payload to the smallest exactly like compression.bdi.bdi_sizes
_BDI_MODES = ((8, 4, 41), (4, 2, 38), (2, 1, 38), (8, 2, 25), (4, 1, 22),
              (8, 1, 17))

_U32 = 0xFFFFFFFF

# kernel launches; only the CUDA path counts
LAUNCHES = {"compress_scan": 0}


# ---------------------------------------------------------------------------
# host-side helpers + numpy reference (uint32 arithmetic), as the reference
# ---------------------------------------------------------------------------

def device_markers(slot_idx, key: int = DEFAULT_MARKER_KEY):
    """(m2, m4) uint32 device markers for an array of slot indices."""
    idx = np.asarray(slot_idx, dtype=np.uint64) & np.uint64(_U32)
    two = (np.uint64(2) * idx + np.uint64(1)) & np.uint64(_U32)
    k = np.uint64(key & _U32)
    m2 = (two * np.uint64(M2_MULT) + k) & np.uint64(_U32)
    m4 = (two * np.uint64(M4_MULT) + k) & np.uint64(_U32)
    return m2.astype(np.uint32), m4.astype(np.uint32)


def device_il_words(slot_idx, key: int = DEFAULT_MARKER_KEY) -> np.ndarray:
    """(N, 16) uint32 invalid-line (Marker-IL) pattern per slot."""
    idx = np.asarray(slot_idx, dtype=np.uint64)[..., None]
    j = np.arange(WORDS_PER_LINE, dtype=np.uint64)[None, :]
    w = ((idx * np.uint64(WORDS_PER_LINE) + j + np.uint64(1))
         * np.uint64(IL_MULT) + np.uint64(key & _U32))
    return (w & np.uint64(_U32)).astype(np.uint32)


def classify_image_ref(lines: np.ndarray, key: int = DEFAULT_MARKER_KEY, *,
                       first_slot: int = 0) -> np.ndarray:
    """Numpy reference for the kernel's marker classification.

    lines: (N, 64) uint8, line i living in slot `first_slot + i`. Returns
    (N,) int32 LineStatus values, with the kernel's priority order
    (COMP2 > COMP4 > INVALID > MAYBE_INVERTED > UNCOMP).
    """
    lines = np.ascontiguousarray(lines, dtype=np.uint8)
    n = lines.shape[0]
    words = lines.view("<u4").reshape(n, WORDS_PER_LINE)
    tail = words[:, -1]
    idx = first_slot + np.arange(n)
    m2, m4 = device_markers(idx, key)
    il = device_il_words(idx, key)
    is2 = tail == m2
    is4 = tail == m4
    is_il = (words == il).all(axis=1)
    inv = (tail == ~m2) | (tail == ~m4) | (words == ~il).all(axis=1)
    out = np.full(n, int(LineStatus.UNCOMP), dtype=np.int32)
    out[inv] = int(LineStatus.MAYBE_INVERTED)
    out[is_il] = int(LineStatus.INVALID)
    out[is4] = int(LineStatus.COMP4)
    out[is2] = int(LineStatus.COMP2)
    return out


# ---------------------------------------------------------------------------
# the plain PyTorch version of the kernel body
# ---------------------------------------------------------------------------

def _sext(x, bits: int):
    """Sign-extend the low `bits` bits of an int64 tensor."""
    half = 1 << (bits - 1)
    return ((x & ((1 << bits) - 1)) ^ half) - half


def _fits(v, d: int):
    lim = 1 << (8 * d - 1)
    return (v >= -lim) & (v < lim)


def _fpc_bytes(w):
    """FPC size in bytes; w (N, 16) int64 holding the int32 word values."""
    u = w & _U32
    lo16, hi16 = _sext(u, 16), _sext(u >> 16, 16)
    b0 = u & 0xFF
    repb = ((b0 == ((u >> 8) & 0xFF)) & (b0 == ((u >> 16) & 0xFF))
            & (b0 == ((u >> 24) & 0xFF)))
    # priority chain (last where wins): raw < half_se8 < pad16 < se16 <
    # repb < se8 < se4 — as fpc._classify_nonzero
    bits = torch.full_like(w, 32)
    bits = torch.where(_fits(lo16, 1) & _fits(hi16, 1), 16, bits)
    bits = torch.where((u & 0xFFFF) == 0, 16, bits)
    bits = torch.where(_fits(w, 2), 16, bits)
    bits = torch.where(repb, 8, bits)
    bits = torch.where(_fits(w, 1), 8, bits)
    bits = torch.where((w >= -8) & (w < 8), 4, bits)
    zero = w == 0
    total = torch.where(zero, 0, 3 + bits).sum(-1)
    # zero runs: a run of length L costs ceil(L/8) chunks of (3+3) bits
    prev = torch.cat([torch.zeros_like(zero[:, :1]), zero[:, :-1]], 1)
    run_id = torch.cumsum((zero & ~prev).to(torch.int64), 1)
    chunks = torch.zeros_like(total)
    for k in range(1, WORDS_PER_LINE + 1):
        len_k = (zero & (run_id == k)).sum(-1)
        chunks = chunks + (len_k + 7) // 8 * (len_k > 0)
    return (total + chunks * 6 + 7) // 8


def _bdi_mode_fits(e, elem_bits: int, d: int):
    """e (N, k) int64 elements (sign-extended): does every element fit in
    d bytes either as itself (immediate) or as a delta, wrapped into the
    element width, from the first non-immediate element?"""
    imm = _fits(e, d)
    nonimm = ~imm
    first = nonimm.to(torch.int32).argmax(-1, keepdim=True)
    base = torch.where(nonimm.any(-1, keepdim=True),
                       torch.gather(e, 1, first), 0)
    delta = e - base
    if elem_bits < 64:
        delta = _sext(delta, elem_bits)
    return (imm | _fits(delta, d)).all(-1)


def _bdi_bytes(lines):
    """Best BDI payload in bytes; lines (N, 64) uint8."""
    elems = {b: lines.view(dt).to(torch.int64)
             for b, dt in ((2, torch.int16), (4, torch.int32),
                           (8, torch.int64))}
    best = torch.full((lines.shape[0],), LINE_BYTES, dtype=torch.int64,
                      device=lines.device)
    for b, d, payload in _BDI_MODES:
        fits = _bdi_mode_fits(elems[b], 8 * b, d)
        best = torch.where(fits & (payload < best), payload, best)
    e8 = elems[8]
    zeros = (e8 == 0).all(-1)
    rep8 = (e8 == e8[:, :1]).all(-1)
    best = torch.where(rep8 & ~zeros, 8, best)
    return torch.where(zeros, 0, best)


def _mul_u32(a, m: int):
    """(a * m) mod 2^32 for int64 a in [0, 2^32) without int64 overflow."""
    lo = (a & 0xFFFF) * m
    hi = ((a >> 16) * m) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _classify(w, slot, key: int):
    """Marker class; w (N, 16) int64 words, slot (N,) int64 slot indices."""
    u = w & _U32
    two = (2 * slot + 1) & _U32
    m2 = (_mul_u32(two, M2_MULT) + key) & _U32
    m4 = (_mul_u32(two, M4_MULT) + key) & _U32
    j = torch.arange(1, WORDS_PER_LINE + 1, device=w.device)
    il = (_mul_u32((slot[:, None] * WORDS_PER_LINE + j) & _U32, IL_MULT)
          + key) & _U32
    tail = u[:, -1]
    is_il = (u == il).all(-1)
    inv = ((tail == (m2 ^ _U32)) | (tail == (m4 ^ _U32))
           | (u == (il ^ _U32)).all(-1))
    out = torch.full_like(tail, int(LineStatus.UNCOMP))
    out = torch.where(inv, int(LineStatus.MAYBE_INVERTED), out)
    out = torch.where(is_il, int(LineStatus.INVALID), out)
    out = torch.where(tail == m4, int(LineStatus.COMP4), out)
    return torch.where(tail == m2, int(LineStatus.COMP2), out)


def _check_lines(lines):
    if lines.dtype != torch.uint8 or lines.dim() != 2 or \
            lines.shape[1] != LINE_BYTES:
        raise ValueError(f"lines must be (N, {LINE_BYTES}) uint8, got "
                         f"{tuple(lines.shape)} {lines.dtype}")


def compress_scan_plain(lines, *, key: int = DEFAULT_MARKER_KEY,
                        first_slot: int = 0) -> dict:
    """Plain version: lines (N, 64) uint8, line i in slot first_slot + i ->
    dict of (N,) int32 tensors (sizes, fpc, bdi, status) on its device."""
    _check_lines(lines)
    lines = lines.contiguous()
    w = lines.view(torch.int32).to(torch.int64)
    fpc = _fpc_bytes(w)
    bdi = _bdi_bytes(lines)
    sizes = torch.clamp(torch.minimum(fpc, bdi), max=LINE_BYTES) + HEADER_BYTES
    slot = first_slot + torch.arange(lines.shape[0], device=lines.device)
    status = _classify(w, slot, key & _U32)
    return {name: t.to(torch.int32) for name, t in
            (("sizes", sizes), ("fpc", fpc), ("bdi", bdi),
             ("status", status))}


def compress_scan_cuda(lines, *, key: int = DEFAULT_MARKER_KEY) -> dict:
    """The CUDA kernel on the same contract as `compress_scan_plain`."""
    _check_lines(lines)
    if lines.device.type != "cuda":
        raise ValueError(f"lines must be a CUDA tensor, got {lines.device}")
    if not lines.is_contiguous() or lines.data_ptr() % 16:
        raise ValueError("lines must be contiguous and 16-byte aligned")
    n = lines.shape[0]
    out = torch.empty((4, n), dtype=torch.int32, device=lines.device)
    if n:
        code = cuda_lib.load().cram_compress_scan(
            cuda_lib.ptr(lines), n, key & _U32,
            cuda_lib.ptr(out), cuda_lib.stream_ptr(lines))
        cuda_lib.check(code, "cram_compress_scan")
        LAUNCHES["compress_scan"] += 1
    return dict(zip(("sizes", "fpc", "bdi", "status"), out.unbind(0),
                    strict=True))


@cuda_lib.kernel_wrapper("compress_scan")
def compress_scan(lines, *, key: int = DEFAULT_MARKER_KEY) -> dict:
    """Scan a memory image in one kernel pass.

    lines: (N, 64) uint8 tensor; line i is taken to live in slot i.
    Returns a dict of (N,) int32 tensors on the same device:
      sizes  — hybrid FPC+BDI compressed size, header included (==
               compression.hybrid.compressed_sizes)
      fpc    — FPC-only size in bytes (no header)
      bdi    — best BDI payload size in bytes (no header)
      status — marker classification (compression.marker.LineStatus)
    """
    if lines.device.type == "cpu":
        return compress_scan_plain(lines, key=key)
    return compress_scan_cuda(lines, key=key)
