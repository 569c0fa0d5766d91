"""repro_torch.compression — the port of `repro.compression`.

  * framing   — the marker-framing constants and the device marker family
  * codecs    — `Codec` registry: raw / bdi / fpc / hybrid line codecs and
                int8-delta / int4-delta page codecs, each with its bit-true
                pack/unpack, size function and (lazily resolved) CUDA
                backend
  * layouts   — `Layout` registry: the Fig. 6 group4 mapping and the KV
                pair/quad slot formats
  * gate      — the §VI saturating-counter gate constants
  * predictor — the KV last-compressibility predictor
  * marker    — host-side keyed markers + implicit-metadata classification
  * fpc/bdi/hybrid/pagepack/bits — codec implementations behind the registry

The line codecs are numpy; the page codecs are torch.
"""

from . import bdi, bits, fpc, framing, gate, hybrid, layouts, marker
from . import pagepack, predictor
from .codecs import Codec, codec_names, get_codec, register_codec
from .framing import (
    HEADER_BYTES,
    LINE_BYTES,
    MARKER_BYTES,
    MARKER_LANES,
    PAYLOAD_BUDGET,
    SLOT_BUDGET,
)
from .layouts import (
    GROUP4,
    KV_PAIR,
    KV_QUAD,
    Layout,
    get_layout,
    layout_names,
    register_layout,
)

__all__ = [
    "bdi", "bits", "fpc", "framing", "gate", "hybrid", "layouts", "marker",
    "pagepack", "predictor",
    "Codec", "codec_names", "get_codec", "register_codec",
    "Layout", "get_layout", "layout_names", "register_layout",
    "GROUP4", "KV_PAIR", "KV_QUAD",
    "LINE_BYTES", "SLOT_BUDGET", "MARKER_BYTES", "MARKER_LANES",
    "PAYLOAD_BUDGET", "HEADER_BYTES",
]
