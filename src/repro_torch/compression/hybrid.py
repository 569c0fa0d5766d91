"""Hybrid FPC+BDI line codec and group packing (§III-A, §V-A).

Each compressed sub-line is encoded as:
    [1-byte header][payload]
      header: high nibble = algorithm (0=BDI, 1=FPC, 2=RAW)
              low nibble  = BDI mode id (BDI only)
The header byte is counted toward the compressed size, as the paper requires
("information about the compression algorithm used ... are stored within the
compressed line, and are counted towards determining the size").

A packed group slot is:
    [sub-line 0][sub-line 1](...)[zero pad][4-byte marker]
with total payload <= 60 bytes (PAYLOAD_BUDGET).  Sub-lines decode strictly
in sequence; FPC is self-terminating at 16 words, BDI/RAW have fixed sizes.

A numpy copy of `repro.compression.hybrid`; `compressed_sizes` takes numpy
only (the scan kernel is the tensor path for sizes).
"""

from __future__ import annotations

import numpy as np

from . import bdi as _bdi
from . import fpc as _fpc
from .framing import HEADER_BYTES, LINE_BYTES, PAYLOAD_BUDGET

ALG_BDI, ALG_FPC, ALG_RAW = 0, 1, 2


def compressed_sizes(lines_bytes):
    """Hybrid FPC+BDI compressed size per line, header included.

    lines_bytes: (N, 64) uint8 -> (N,) int32 sizes in [1+0, 1+64].
    """
    fpc_sz = _fpc.fpc_size_bytes(lines_bytes)
    bdi_sz, _ = _bdi.bdi_sizes(lines_bytes)
    best = np.minimum(np.minimum(fpc_sz, bdi_sz), LINE_BYTES)
    return (best + HEADER_BYTES).astype(np.int32)


def compress_line(line: np.ndarray) -> bytes:
    """Exact hybrid encoding of one 64-byte line (header + payload)."""
    line = np.asarray(line, dtype=np.uint8).reshape(1, LINE_BYTES)
    bdi_sz, bdi_mode = _bdi.bdi_sizes(line)
    bdi_sz, bdi_mode = int(bdi_sz[0]), int(bdi_mode[0])
    fpc_payload = _fpc.fpc_pack(line[0])
    fpc_sz = len(fpc_payload)
    best = min(bdi_sz, fpc_sz, LINE_BYTES)
    if best == bdi_sz and bdi_sz <= fpc_sz:
        hdr = (ALG_BDI << 4) | bdi_mode
        payload = _bdi.bdi_pack_batch(line, bdi_mode)[0].tobytes()
    elif best == fpc_sz:
        hdr = ALG_FPC << 4
        payload = fpc_payload
    else:
        hdr = ALG_RAW << 4
        payload = line[0].tobytes()
    return bytes([hdr]) + payload


def compress_batch(lines_bytes: np.ndarray) -> np.ndarray:
    """Vectorized exact hybrid encoding of (N, 64) lines.

    Byte-identical to ``b"".join(compress_line(l) for l in lines)`` with no
    per-line Python loop: the algorithm choice is vectorized, BDI payloads
    scatter per mode group (as in the checkpoint BDI stream), FPC payloads
    come from `fpc.fpc_pack_batch`.  Returns the 1-D uint8 stream.
    """
    lines = np.ascontiguousarray(lines_bytes, dtype=np.uint8).reshape(
        -1, LINE_BYTES)
    n = lines.shape[0]
    if n == 0:
        return np.zeros(0, np.uint8)
    fpc_sz = _fpc.fpc_size_bytes(lines).astype(np.int64)
    bdi_sz, bdi_mode = _bdi.bdi_sizes(lines)
    bdi_sz = bdi_sz.astype(np.int64)
    best = np.minimum(np.minimum(bdi_sz, fpc_sz), LINE_BYTES)
    # same precedence as compress_line: BDI on ties (incl. its RAW mode)
    take_bdi = (best == bdi_sz) & (bdi_sz <= fpc_sz)
    take_fpc = ~take_bdi & (best == fpc_sz)
    alg = np.where(take_bdi, ALG_BDI, np.where(take_fpc, ALG_FPC, ALG_RAW))
    payload_sz = np.where(take_bdi, bdi_sz,
                          np.where(take_fpc, fpc_sz, LINE_BYTES))
    stored = HEADER_BYTES + payload_sz
    off = np.cumsum(stored) - stored
    buf = np.zeros(int(off[-1] + stored[-1]), np.uint8)
    buf[off] = (alg << 4 | np.where(take_bdi, bdi_mode, 0)).astype(np.uint8)
    for m in np.unique(bdi_mode[take_bdi]):
        idxs = np.flatnonzero(take_bdi & (bdi_mode == m))
        payload = _bdi.bdi_pack_batch(lines[idxs], int(m))
        if payload.shape[1]:
            buf[off[idxs][:, None] + 1 + np.arange(payload.shape[1])] = \
                payload
    fidx = np.flatnonzero(take_fpc)
    if fidx.size:
        stream = _fpc.fpc_pack_batch(lines[fidx])
        sizes = fpc_sz[fidx]
        sub_off = np.cumsum(sizes) - sizes
        intra = np.arange(int(sizes.sum())) - np.repeat(sub_off, sizes)
        buf[np.repeat(off[fidx] + 1, sizes) + intra] = stream
    ridx = np.flatnonzero(alg == ALG_RAW)
    if ridx.size:
        buf[off[ridx][:, None] + 1 + np.arange(LINE_BYTES)] = lines[ridx]
    return buf


def decompress_line(data: bytes, offset: int = 0) -> tuple[np.ndarray, int]:
    """Decode one sub-line starting at `offset`; returns (line64, next_offset)."""
    hdr = data[offset]
    alg, mode = hdr >> 4, hdr & 0xF
    offset += 1
    if alg == ALG_RAW:
        out = np.frombuffer(data[offset : offset + LINE_BYTES], dtype=np.uint8)
        return out.copy(), offset + LINE_BYTES
    if alg == ALG_BDI:
        n = _bdi.PAYLOAD_BYTES[mode]
        payload = np.frombuffer(data[offset : offset + n], dtype=np.uint8)
        out = _bdi.bdi_unpack_batch(payload.reshape(1, n), mode)[0]
        return out, offset + n
    if alg == ALG_FPC:
        # FPC is self-terminating: decode 16 words, then advance by the
        # number of whole bytes consumed.  The slice is bounded by the
        # worst-case FPC line (16 x 35 bits = 70 B) so streaming decoders
        # stay O(total bytes) instead of copying the whole tail per line.
        line = _fpc.fpc_unpack(data[offset : offset + _fpc.MAX_LINE_BYTES])
        # recompute consumed bits via the size function (exact)
        nbytes = int(_fpc.fpc_size_bytes(line.reshape(1, LINE_BYTES))[0])
        return line, offset + nbytes
    raise ValueError(f"bad header {hdr:#x}")


def pack_group(lines: list[np.ndarray], marker: bytes) -> np.ndarray | None:
    """Pack 2 or 4 lines + marker into one 64B slot, or None if they don't fit."""
    assert len(lines) in (2, 4)
    blob = b"".join(compress_line(l) for l in lines)
    if len(blob) > PAYLOAD_BUDGET:
        return None
    slot = np.zeros(LINE_BYTES, dtype=np.uint8)
    slot[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    slot[-len(marker):] = np.frombuffer(marker, dtype=np.uint8)
    return slot


def unpack_group(slot: np.ndarray, n_lines: int) -> list[np.ndarray]:
    """Decode `n_lines` sub-lines from a packed slot."""
    data = bytes(np.asarray(slot, dtype=np.uint8).tobytes())
    out, ofs = [], 0
    for _ in range(n_lines):
        line, ofs = decompress_line(data, ofs)
        out.append(line)
    if ofs > PAYLOAD_BUDGET:
        raise ValueError("packed group overruns the 60-byte payload budget")
    return out


def group_fits(sizes, lanes=(0, 1), budget: int = PAYLOAD_BUDGET) -> bool:
    return int(sum(int(sizes[l]) for l in lanes)) <= budget
