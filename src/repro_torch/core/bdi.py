"""Moved: repro_torch.compression.bdi is the implementation (BDI line codec)."""

from ..compression.bdi import (  # noqa: F401
    BD_MODES,
    LINE_BYTES,
    M_B2D1,
    M_B4D1,
    M_B4D2,
    M_B8D1,
    M_B8D2,
    M_B8D4,
    M_RAW,
    M_REP8,
    M_ZEROS,
    MODE_BY_ID,
    PAYLOAD_BYTES,
    bdi_pack_batch,
    bdi_sizes,
    bdi_unpack_batch,
)
