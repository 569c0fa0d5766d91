"""Moved: repro_torch.compression.layouts is the implementation (the Fig. 6
GROUP4 mapping as an instance of the marker-framed Layout protocol)."""

from ..compression.framing import (  # noqa: F401
    MARKER_BYTES,
    PAYLOAD_BUDGET,
    SLOT_BUDGET,
)
from ..compression.layouts import (  # noqa: F401
    CANDIDATES,
    GROUP4,
    GROUP_LINES,
    LANE_LEVEL,
    LANES_IN_SLOT,
    LINES_IN_SLOT,
    LOC,
    N_STATES,
    OCCUPIED,
    PRED_SLOT,
    S_AB,
    S_AB_CD,
    S_CD,
    S_QUAD,
    S_U,
    STATE_NAMES,
    VACATED,
    choose_state,
    fits_to_state,
    probe_chain,
    slot_of,
)
