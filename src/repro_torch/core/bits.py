"""Moved: repro_torch.compression.bits is the implementation (codec bit plumbing)."""

from ..compression.bits import (  # noqa: F401
    BitReader,
    BitWriter,
    bytes_to_u32,
    sign_extend,
    u32_to_bytes,
)
