"""Moved: repro_torch.compression.marker is the implementation (host-side keyed
markers + implicit-metadata line classification, §V-A)."""

from ..compression.framing import LINE_BYTES, MARKER_BYTES  # noqa: F401
from ..compression.marker import (  # noqa: F401
    LineStatus,
    MarkerSpec,
    classify_line,
    collision_probability,
    invert_line,
    needs_inversion,
)
