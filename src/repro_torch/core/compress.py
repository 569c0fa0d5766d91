"""Moved: repro_torch.compression.hybrid is the implementation (hybrid FPC+BDI
line codec and marker-framed group packing)."""

from ..compression.hybrid import (  # noqa: F401
    ALG_BDI,
    ALG_FPC,
    ALG_RAW,
    HEADER_BYTES,
    LINE_BYTES,
    compress_line,
    compressed_sizes,
    decompress_line,
    group_fits,
    pack_group,
    unpack_group,
)
