"""Base-Delta-Immediate (BDI) compression [Pekhimenko et al., PACT 2012].

A 64-byte line is viewed as k elements of `base_bytes` each; it compresses if
every element is either within a signed `delta_bytes` range of a common base
(taken as the first non-immediate element) or of zero ("immediate").  A k-bit
mask records which base each element used.  Special modes: all-zero line and
a line of one repeated 8-byte value.

Layout of a packed payload (mode-specific, fixed size):
    [base: b bytes LE][mask: ceil(k/8) bytes][deltas: k*d bytes LE]

All arithmetic is two's-complement wrapping, which makes the encode/decode
pair exact even when the "true" delta overflows: the decoder adds the
sign-extended residue back with wrapping.

A numpy copy of `repro.compression.bdi`: `bdi_sizes` is vectorized over
numpy arrays (the reference's also takes `xp=jax.numpy`; the port's tensor
path for sizes is the scan kernel, `kernels/compress_scan.py`);
`bdi_pack_batch` / `bdi_unpack_batch` are the exact vectorized byte paths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LINE_BYTES = 64

# mode ids (stable; stored in the 1-byte hybrid header by compress.py)
M_ZEROS, M_REP8, M_B8D1, M_B8D2, M_B8D4, M_B4D1, M_B4D2, M_B2D1, M_RAW = range(9)


@dataclass(frozen=True)
class _Mode:
    mode: int
    base_bytes: int
    delta_bytes: int

    @property
    def k(self) -> int:
        return LINE_BYTES // self.base_bytes

    @property
    def mask_bytes(self) -> int:
        return (self.k + 7) // 8

    @property
    def payload_bytes(self) -> int:
        return self.base_bytes + self.mask_bytes + self.k * self.delta_bytes


BD_MODES = (
    _Mode(M_B8D1, 8, 1),   # 17
    _Mode(M_B8D2, 8, 2),   # 25
    _Mode(M_B8D4, 8, 4),   # 41
    _Mode(M_B4D1, 4, 1),   # 22
    _Mode(M_B4D2, 4, 2),   # 38
    _Mode(M_B2D1, 2, 1),   # 38
)
MODE_BY_ID = {m.mode: m for m in BD_MODES}

PAYLOAD_BYTES = {
    M_ZEROS: 0,
    M_REP8: 8,
    M_RAW: LINE_BYTES,
    **{m.mode: m.payload_bytes for m in BD_MODES},
}

_INT_DTYPES = {1: "<i1", 2: "<i2", 4: "<i4", 8: "<i8"}


def _elems_np(lines: np.ndarray, b: int) -> np.ndarray:
    """(N,64) uint8 -> (N, 64//b) signed ints, little-endian."""
    lines = np.ascontiguousarray(lines, dtype=np.uint8)
    return lines.view(_INT_DTYPES[b]).reshape(lines.shape[0], LINE_BYTES // b)


def _mode_fits(elems, d: int):
    """elems: (N,k) signed. Returns (fits (N,), base (N,), imm_mask (N,k))."""
    e = elems.astype(np.int64)
    lo, hi = -(1 << (8 * d - 1)), (1 << (8 * d - 1))
    imm = (e >= lo) & (e < hi)
    any_nonimm = ~imm.all(axis=-1)
    first_nonimm = np.argmax(~imm, axis=-1)
    base = np.take_along_axis(e, first_nonimm[..., None], axis=-1)[..., 0]
    base = np.where(any_nonimm, base, 0)
    # wrapping residue; two's complement keeps encode/decode exact
    delta = (e - base[..., None]).astype(elems.dtype).astype(np.int64)
    from_base = (delta >= lo) & (delta < hi)
    fits = (imm | from_base).all(axis=-1)
    return fits, base, imm


def bdi_sizes(lines_bytes):
    """Vectorized best-BDI-mode search.

    lines_bytes: (N, 64) uint8.
    Returns (sizes (N,) int32 payload bytes, modes (N,) int32).
    """
    lines_bytes = np.asarray(lines_bytes)
    n = lines_bytes.shape[0]
    e8 = _elems_np(lines_bytes, 8)
    zeros = (e8 == 0).all(axis=-1)
    rep8 = (e8 == e8[..., :1]).all(axis=-1) & ~zeros

    best_size = np.full((n,), LINE_BYTES, dtype=np.int32)
    best_mode = np.full((n,), M_RAW, dtype=np.int32)
    # evaluate fixed modes from largest payload to smallest so that the
    # smallest fitting payload wins the final where-chain
    for m in sorted(BD_MODES, key=lambda m: -m.payload_bytes):
        elems = _elems_np(lines_bytes, m.base_bytes)
        fits, _, _ = _mode_fits(elems, m.delta_bytes)
        take = fits & (m.payload_bytes < best_size)
        best_size = np.where(take, m.payload_bytes, best_size)
        best_mode = np.where(take, m.mode, best_mode)
    best_size = np.where(rep8, PAYLOAD_BYTES[M_REP8], best_size)
    best_mode = np.where(rep8, M_REP8, best_mode)
    best_size = np.where(zeros, PAYLOAD_BYTES[M_ZEROS], best_size)
    best_mode = np.where(zeros, M_ZEROS, best_mode)
    return best_size.astype(np.int32), best_mode.astype(np.int32)


# ---------------------------------------------------------------------------
# Exact vectorized pack / unpack (numpy)
# ---------------------------------------------------------------------------

def bdi_pack_batch(lines: np.ndarray, mode: int) -> np.ndarray:
    """Pack (N,64) lines, all with the given mode, -> (N, payload) uint8.

    Caller must have verified the mode fits (e.g. via bdi_sizes).
    """
    lines = np.ascontiguousarray(lines, dtype=np.uint8)
    n = lines.shape[0]
    if mode == M_ZEROS:
        return np.zeros((n, 0), dtype=np.uint8)
    if mode == M_REP8:
        return lines[:, :8].copy()
    if mode == M_RAW:
        return lines.copy()
    m = MODE_BY_ID[mode]
    elems = _elems_np(lines, m.base_bytes).astype(np.int64)
    fits, base, imm = _mode_fits(elems, m.delta_bytes)
    if not bool(np.all(fits)):
        raise ValueError(f"some lines do not fit BDI mode {mode}")
    chosen_base = np.where(imm, 0, base[:, None])
    delta = (elems - chosen_base).astype(_INT_DTYPES[m.delta_bytes])
    base_b = base.astype(_INT_DTYPES[m.base_bytes])[:, None].view(np.uint8)
    base_b = base_b.reshape(n, m.base_bytes)
    mask_bits = np.packbits(imm.astype(np.uint8), axis=-1, bitorder="little")
    delta_b = np.ascontiguousarray(delta).view(np.uint8).reshape(n, -1)
    return np.concatenate([base_b, mask_bits, delta_b], axis=1)


def bdi_unpack_batch(payload: np.ndarray, mode: int) -> np.ndarray:
    """Inverse of bdi_pack_batch: (N, payload) uint8 -> (N, 64) uint8."""
    payload = np.ascontiguousarray(payload, dtype=np.uint8)
    n = payload.shape[0]
    if mode == M_ZEROS:
        return np.zeros((n, LINE_BYTES), dtype=np.uint8)
    if mode == M_REP8:
        return np.tile(payload, (1, LINE_BYTES // 8))
    if mode == M_RAW:
        return payload.copy()
    m = MODE_BY_ID[mode]
    ofs = 0
    base = payload[:, ofs : ofs + m.base_bytes].copy().view(
        _INT_DTYPES[m.base_bytes]
    ).astype(np.int64)[:, 0]
    ofs += m.base_bytes
    mask = np.unpackbits(
        payload[:, ofs : ofs + m.mask_bytes], axis=-1, bitorder="little"
    )[:, : m.k].astype(bool)
    ofs += m.mask_bytes
    delta = (
        payload[:, ofs:].copy().view(_INT_DTYPES[m.delta_bytes]).astype(np.int64)
    )
    chosen_base = np.where(mask, 0, base[:, None])
    elems = (chosen_base + delta).astype(_INT_DTYPES[m.base_bytes])
    return np.ascontiguousarray(elems).view(np.uint8).reshape(n, LINE_BYTES)
