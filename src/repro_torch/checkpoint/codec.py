"""CRAM checkpoint codec: the paper's line compression applied to restart
bandwidth (port of `repro.checkpoint.codec`, byte for byte the same
stream).

Tensors are carved into 64-byte lines and streamed through a registered
line codec (`repro_torch.compression.codecs`): each line is stored in the
codec's self-describing format (BDI's 1-byte mode header, the hybrid
codec's algorithm header, FPC's self-terminating stream), so
decompression needs only the line count.  An optional zstd outer layer
(`use_zstd`) needs the `zstandard` package and raises where it is
missing.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from ..compression import bdi
from ..compression.codecs import codec_names, get_codec
from ..compression.framing import LINE_BYTES as LINE

# v2 streams carry a codec-id byte in the header; v1 (pre-registry) blobs
# had no codec byte and are always BDI
_MAGIC = b"CRAMCKP2"
_MAGIC_V1 = b"CRAMCKPT"
# stream codec ids (stable on-disk values)
_CODEC_IDS = {"bdi": 0, "hybrid": 1, "fpc": 2, "raw": 3}
_CODEC_BY_ID = {v: k for k, v in _CODEC_IDS.items()}


def _zstd():
    try:
        import zstandard
    except ModuleNotFoundError:
        raise RuntimeError(
            "a '+zstd' checkpoint stream needs the zstandard package, "
            "which is not installed; use a codec without '+zstd'") from None
    return zstandard


def pad_to_lines(raw: bytes) -> np.ndarray:
    """(len,) bytes -> (N, 64) uint8 lines, zero-padded to a line
    multiple: the framing of both the stored stream and the AutoTuner's
    codec probes."""
    n = (len(raw) + LINE - 1) // LINE * LINE
    buf = np.zeros(n, np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    return buf.reshape(-1, LINE)


def _bdi_unpack_stream(view: np.ndarray, n_lines: int) -> np.ndarray:
    # pass 1: walk the mode bytes to recover offsets (the stream is
    # self-describing, like the memory image)
    size_table = [bdi.PAYLOAD_BYTES[m] for m in range(9)]
    modes = np.empty(n_lines, np.uint8)
    offsets = np.empty(n_lines, np.int64)
    ofs = 0
    for i in range(n_lines):
        m = view[ofs]
        modes[i] = m
        offsets[i] = ofs + 1
        ofs += 1 + size_table[m]
    # pass 2: unpack each mode's lines together
    out = np.empty((n_lines, LINE), np.uint8)
    for m in np.unique(modes):
        idxs = np.flatnonzero(modes == m)
        n = size_table[m]
        if n:
            payload = view[offsets[idxs][:, None] + np.arange(n)]
        else:
            payload = np.zeros((len(idxs), 0), np.uint8)
        out[idxs] = bdi.bdi_unpack_batch(payload, int(m))
    return out


def cram_compress_bytes(raw: bytes, use_zstd: bool = False,
                        codec: str = "bdi") -> bytes:
    """Compress a byte string through a registered CRAM line codec."""
    if codec not in _CODEC_IDS:
        raise ValueError(
            f"unknown checkpoint codec {codec!r}; valid: {sorted(_CODEC_IDS)}"
            f" (registered line codecs: {sorted(codec_names('line64'))})")
    lines = pad_to_lines(raw)
    out = io.BytesIO()
    out.write(_MAGIC)
    out.write(struct.pack("<QQBB", len(raw), lines.shape[0],
                          1 if use_zstd else 0, _CODEC_IDS[codec]))
    body = get_codec(codec).pack_batch(lines).tobytes()
    if use_zstd:
        body = _zstd().ZstdCompressor(level=3).compress(body)
    out.write(body)
    return out.getvalue()


def cram_decompress_bytes(blob: bytes) -> bytes:
    if blob[:8] == _MAGIC_V1:           # legacy header: no codec byte, BDI
        raw_len, n_lines, zflag = struct.unpack_from("<QQB", blob, 8)
        codec_id, body = _CODEC_IDS["bdi"], blob[8 + 17:]
    else:
        if blob[:8] != _MAGIC:
            raise ValueError("not a CRAM checkpoint stream")
        raw_len, n_lines, zflag, codec_id = struct.unpack_from(
            "<QQBB", blob, 8)
        body = blob[8 + 18:]
    if zflag:
        body = _zstd().ZstdDecompressor().decompress(body)
    codec = _CODEC_BY_ID[codec_id]
    if codec == "bdi":
        out = _bdi_unpack_stream(np.frombuffer(body, np.uint8), n_lines)
    else:
        unpack_line = get_codec(codec).unpack_line
        out = np.empty((n_lines, LINE), np.uint8)
        ofs = 0
        for i in range(n_lines):
            out[i], ofs = unpack_line(body, ofs)
    return out.reshape(-1)[:raw_len].tobytes()


def compression_ratio(raw: bytes, codec: str = "bdi") -> float:
    return len(raw) / max(len(cram_compress_bytes(raw, codec=codec)), 1)
