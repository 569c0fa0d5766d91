"""Codec registry: every compression algorithm of the port, as data (the
counterpart of `repro.compression.codecs`, same names, same order).

A `Codec` record names, per algorithm, its bit-true pack/unpack, its size
function and its device backends, so `kernels/compress_scan.py` and
`kernels/bdi_pack.py` are registered backends of the same codecs, not
parallel truths.

Two codec units exist:
  * "line64" — 64-byte memory lines (raw / bdi / fpc / hybrid);
    `size_fn(lines_bytes)` returns per-line compressed sizes in bytes on a
    numpy array (header included where the codec has one), and
    `pack_line`/`unpack_line`/`pack_batch` are the exact host byte paths.
    The reference's size functions also take `xp=jax.numpy`; here the
    tensor path for sizes is the scan backend, on the card.
  * "page" — groups of KV pages ((page, Hkv, D2) int16 tiles);
    `pack_pages`/`unpack_pages` are the bit-true torch group codecs
    (compression.pagepack), the device pair packs and unpacks groups.

The field and method names (`pallas_pack`, `pallas_unpack`, `pallas_scan`,
`pallas()`, `scan()`, `has_pallas()`) are the reference's, so the two
registries compare field by field; on the port they resolve to the CUDA
kernels' wrappers in `repro_torch.kernels`.  Backends are dotted paths
resolved lazily, so importing the registry builds nothing.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable

import numpy as np

from . import bdi as _bdi
from . import fpc as _fpc
from . import hybrid as _hybrid
from . import pagepack as _pagepack
from .framing import LINE_BYTES


def _resolve(dotted: str) -> Callable:
    mod, _, attr = dotted.rpartition(":")
    return getattr(importlib.import_module(mod), attr)


@dataclass(frozen=True)
class Codec:
    """One registered compression algorithm (see module docstring)."""

    name: str
    unit: str                                  # "line64" | "page"
    description: str = ""
    # line64 contract
    size_fn: Callable | None = None            # (lines_bytes,) -> sizes
    pack_line: Callable | None = None          # (line64,) -> bytes
    unpack_line: Callable | None = None        # (data, ofs) -> (line, next)
    # vectorized exact pack: (N,64) uint8 -> 1-D uint8 concatenated stream,
    # byte-identical to b"".join(pack_line(l) for l in lines)
    pack_batch: Callable | None = None
    # page contract
    group_lanes: int = 0                       # pages packed per slot
    pack_pages: Callable | None = None         # (*pages) -> (ok, packed, base)
    unpack_pages: Callable | None = None       # (packed, base) -> pages
    # lazy device backends (dotted "module:attr" paths): page codecs
    # register a (pack, unpack) kernel pair; line codecs register the
    # one-pass size/marker scan plus the output column carrying this
    # codec's sizes.
    pallas_pack: str | None = None
    pallas_unpack: str | None = None
    pallas_scan: str | None = None
    scan_field: str | None = None              # compress_scan output column

    def sizes(self, lines_bytes):
        if self.size_fn is None:
            raise ValueError(f"codec {self.name!r} has no size function")
        return self.size_fn(lines_bytes)

    def pallas(self) -> tuple[Callable, Callable] | None:
        """Resolve the (pack, unpack) device kernel pair, if registered."""
        if self.pallas_pack is None:
            return None
        return _resolve(self.pallas_pack), _resolve(self.pallas_unpack)

    def scan(self) -> Callable | None:
        """Resolve the device size-scan backend, if registered."""
        return None if self.pallas_scan is None else _resolve(self.pallas_scan)

    def has_pallas(self) -> bool:
        return self.pallas_pack is not None or self.pallas_scan is not None


_REGISTRY: dict[str, Codec] = {}


def register_codec(codec: Codec, *, overwrite: bool = False) -> Codec:
    if codec.name in _REGISTRY and not overwrite:
        raise ValueError(f"codec {codec.name!r} is already registered")
    _REGISTRY[codec.name] = codec
    return codec


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown codec {name!r}; valid: {sorted(_REGISTRY)}") from None


def codec_names(unit: str | None = None) -> tuple[str, ...]:
    return tuple(n for n, c in _REGISTRY.items()
                 if unit is None or c.unit == unit)


# ------------------------------------------------------------- line64 codecs

def _raw_sizes(lines_bytes):
    return np.full(np.shape(lines_bytes)[:-1], LINE_BYTES, dtype=np.int32)


def _raw_pack(line) -> bytes:
    return np.asarray(line, dtype=np.uint8).tobytes()


def _raw_unpack(data: bytes, offset: int = 0):
    out = np.frombuffer(data[offset:offset + LINE_BYTES], dtype=np.uint8)
    return out.copy(), offset + LINE_BYTES


def _bdi_sizes(lines_bytes):
    sizes, _ = _bdi.bdi_sizes(lines_bytes)
    return sizes + 1          # 1-byte self-describing mode header


def _bdi_pack(line) -> bytes:
    arr = np.asarray(line, dtype=np.uint8).reshape(1, LINE_BYTES)
    _, modes = _bdi.bdi_sizes(arr)
    mode = int(modes[0])
    return bytes([mode]) + _bdi.bdi_pack_batch(arr, mode)[0].tobytes()


def _bdi_unpack(data: bytes, offset: int = 0):
    mode = data[offset]
    n = _bdi.PAYLOAD_BYTES[mode]
    payload = np.frombuffer(data[offset + 1: offset + 1 + n], dtype=np.uint8)
    return _bdi.bdi_unpack_batch(payload.reshape(1, n), mode)[0], offset + 1 + n


def _fpc_unpack(data: bytes, offset: int = 0):
    line = _fpc.fpc_unpack(data[offset: offset + _fpc.MAX_LINE_BYTES])
    nbytes = int(_fpc.fpc_size_bytes(line.reshape(1, LINE_BYTES))[0])
    return line, offset + nbytes


def _raw_pack_batch(lines: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(lines, dtype=np.uint8).reshape(-1)


def _bdi_pack_batch(lines: np.ndarray) -> np.ndarray:
    """Vectorized BDI stream: per line, 1 mode byte + payload (identical to
    per-line `_bdi_pack` joins; payloads scatter by mode group)."""
    lines = np.ascontiguousarray(lines, dtype=np.uint8).reshape(
        -1, LINE_BYTES)
    _, modes = _bdi.bdi_sizes(lines)
    size_table = np.asarray([_bdi.PAYLOAD_BYTES[m] for m in range(9)],
                            np.int64)
    per_line = 1 + size_table[modes]
    offsets = np.cumsum(per_line) - per_line
    buf = np.zeros(int(per_line.sum()), np.uint8)
    buf[offsets] = modes.astype(np.uint8)
    for m in np.unique(modes):
        idxs = np.flatnonzero(modes == m)
        payload = _bdi.bdi_pack_batch(lines[idxs], int(m))
        if payload.shape[1]:
            buf[offsets[idxs][:, None] + 1 + np.arange(payload.shape[1])] \
                = payload
    return buf


_SCAN = "repro_torch.kernels.compress_scan:compress_scan"

register_codec(Codec(
    name="raw", unit="line64",
    description="identity (uncompressed 64B line)",
    size_fn=_raw_sizes, pack_line=_raw_pack, unpack_line=_raw_unpack,
    pack_batch=_raw_pack_batch,
))

register_codec(Codec(
    name="bdi", unit="line64",
    description="Base-Delta-Immediate [PACT 2012]; 1-byte mode header",
    size_fn=_bdi_sizes, pack_line=_bdi_pack, unpack_line=_bdi_unpack,
    pack_batch=_bdi_pack_batch,
    pallas_scan=_SCAN, scan_field="bdi",
))

register_codec(Codec(
    name="fpc", unit="line64",
    description="Frequent Pattern Compression [ISCA 2004]; self-terminating",
    size_fn=_fpc.fpc_size_bytes,
    pack_line=_fpc.fpc_pack, unpack_line=_fpc_unpack,
    pack_batch=_fpc.fpc_pack_batch,
    pallas_scan=_SCAN, scan_field="fpc",
))

register_codec(Codec(
    name="hybrid", unit="line64",
    description="best-of FPC+BDI with a 1-byte algorithm header (§III-A) — "
                "the paper's line codec",
    size_fn=_hybrid.compressed_sizes,
    pack_line=_hybrid.compress_line, unpack_line=_hybrid.decompress_line,
    pack_batch=_hybrid.compress_batch,
    pallas_scan=_SCAN, scan_field="sizes",
))


# -------------------------------------------------------------- page codecs

register_codec(Codec(
    name="int8-delta", unit="page", group_lanes=2,
    description="KV 2:1 page pairs: int8 deltas vs the pair base row",
    pack_pages=_pagepack.pack_pair, unpack_pages=_pagepack.unpack_pair,
    pallas_pack="repro_torch.kernels.bdi_pack:pack_pair",
    pallas_unpack="repro_torch.kernels.bdi_pack:unpack_pair",
))

register_codec(Codec(
    name="int4-delta", unit="page", group_lanes=4,
    description="KV 4:1 page quads: int4 deltas vs the quad base row",
    pack_pages=_pagepack.pack_quad, unpack_pages=_pagepack.unpack_quad,
    pallas_pack="repro_torch.kernels.bdi_pack:pack_quad",
    pallas_unpack="repro_torch.kernels.bdi_pack:unpack_quad",
))
