"""Moved: repro_torch.compression.predictor is the implementation (THE line
location predictor, §V-B)."""

from ..compression.predictor import (  # noqa: F401
    _HASH_MULT,
    HASH_MULT,
    LCT_ENTRIES,
    LINES_PER_PAGE,
    LLP,
    lct_index,
    llp_predict,
    llp_update,
    page_of,
)
