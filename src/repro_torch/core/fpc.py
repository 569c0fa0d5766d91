"""Moved: repro_torch.compression.fpc is the implementation (FPC line codec)."""

from ..compression.fpc import (  # noqa: F401
    P_HALF_SE8,
    P_PAD16,
    P_RAW,
    P_REPB,
    P_SE4,
    P_SE8,
    P_SE16,
    P_ZRUN,
    PREFIX_BITS,
    WORDS_PER_LINE,
    fpc_pack,
    fpc_size_bits,
    fpc_size_bytes,
    fpc_unpack,
)
