"""Layouts: restricted line-to-slot mappings as one marker-framed protocol.

A `Layout` describes how a group of `n_lanes` logical lines is placed into
physical slots: the per-state slot map, which slots are vacated (and hence
hold Marker-IL), each lane's *candidate-slot table* (what makes the
line-location prediction problem small, §V-B), and the slot predicted for a
given compressibility level.  The Fig. 6 four-line group mapping of the
memory system and the CRAM-KV page-pair / page-quad slot formats are
instances of the same protocol — one location-predictor implementation
(compression.predictor) works against any of them via `candidates` /
`pred_slot`.

A copy of `repro.compression.layouts`.  The GROUP4 tables below are the
Fig. 6 mapping:

        lane:     A  B  C  D        vacated (Marker-IL) slots
  S_U          :  0  1  2  3        -
  S_AB         :  0  0  2  3        1
  S_CD         :  0  1  2  2        3
  S_AB_CD      :  0  0  2  2        1, 3
  S_QUAD       :  0  0  0  0        1, 2, 3

The Compression Status Information (CSI) for a group is one of these five
states = 3 bits/group = 0.75 bits/line (matches §IV-B's 24MB for 16GB).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .framing import MARKER_BYTES, PAYLOAD_BUDGET, SLOT_BUDGET

GROUP_LINES = 4

S_U, S_AB, S_CD, S_AB_CD, S_QUAD = range(5)
N_STATES = 5
STATE_NAMES = ("uncomp", "AB", "CD", "AB+CD", "quad")

# LOC[state][lane] -> slot holding that lane's data
LOC = np.asarray(
    [
        [0, 1, 2, 3],
        [0, 0, 2, 3],
        [0, 1, 2, 2],
        [0, 0, 2, 2],
        [0, 0, 0, 0],
    ],
    dtype=np.int32,
)

# VACATED[state][slot] -> slot holds Marker-IL
VACATED = np.asarray(
    [
        [0, 0, 0, 0],
        [0, 1, 0, 0],
        [0, 0, 0, 1],
        [0, 1, 0, 1],
        [0, 1, 1, 1],
    ],
    dtype=bool,
)

# OCCUPIED[state][slot] -> slot holds data (lead slot of a packed run or a
# plain uncompressed line)
OCCUPIED = ~VACATED

# How many lines live in a given slot for a given state (0 if vacated)
LINES_IN_SLOT = np.asarray(
    [
        [1, 1, 1, 1],
        [2, 0, 1, 1],
        [1, 1, 2, 0],
        [2, 0, 2, 0],
        [4, 0, 0, 0],
    ],
    dtype=np.int32,
)

# Lanes resident in (state, slot): bitmask over lanes
LANES_IN_SLOT = np.asarray(
    [
        [0b0001, 0b0010, 0b0100, 0b1000],
        [0b0011, 0, 0b0100, 0b1000],
        [0b0001, 0b0010, 0b1100, 0],
        [0b0011, 0, 0b1100, 0],
        [0b1111, 0, 0, 0],
    ],
    dtype=np.int32,
)

# candidate probe order per lane: own/leader slots from "least compressed"
# to "most compressed". The controller probes from its *predicted* slot and
# then walks the remaining candidates.
CANDIDATES = ((0,), (1, 0), (2, 0), (3, 2, 0))

# Per-lane compressibility level observed from a state (0=uncomp, 1=2:1, 2=4:1)
LANE_LEVEL = np.asarray(
    [
        [0, 0, 0, 0],
        [1, 1, 0, 0],
        [0, 0, 1, 1],
        [1, 1, 1, 1],
        [2, 2, 2, 2],
    ],
    dtype=np.int32,
)

# Slot predicted for (lane, predicted_level): level 2 -> slot 0; level 1 ->
# pair-leader slot; level 0 -> own slot.
PRED_SLOT = np.asarray(
    [
        [0, 0, 0],
        [1, 0, 0],
        [2, 2, 0],
        [3, 2, 0],
    ],
    dtype=np.int32,
)


@dataclass(frozen=True)
class Layout:
    """A restricted mapping of `n_lanes` lines onto marker-framed slots.

    Tables are per-state (axis 0) x per-lane/slot (axis 1); `candidates`
    is the per-lane probe-candidate tuple the location predictor draws
    from, `pred_slot[lane, level]` the slot a predicted compressibility
    level resolves to.  `slot_budget`/`marker_bytes` frame each slot
    (framing.py constants for the 64B line layouts; the KV layouts carry
    the marker in the base strip's tail lanes instead, so their full slot
    budget holds payload).
    """
    name: str
    n_lanes: int
    loc: np.ndarray
    vacated: np.ndarray
    lines_in_slot: np.ndarray
    lanes_in_slot: np.ndarray
    lane_level: np.ndarray
    candidates: tuple
    pred_slot: np.ndarray
    state_names: tuple
    slot_budget: int = SLOT_BUDGET
    marker_bytes: int = MARKER_BYTES
    payload_budget: int = PAYLOAD_BUDGET
    description: str = ""

    @property
    def n_states(self) -> int:
        return self.loc.shape[0]

    def slot_of(self, state: int, lane: int) -> int:
        return int(self.loc[state][lane])

    def probe_chain(self, lane: int, predicted_slot: int) -> list[int]:
        """Probe order: predicted slot first, then remaining candidates."""
        cands = list(self.candidates[lane])
        if predicted_slot in cands:
            cands.remove(predicted_slot)
        return [predicted_slot] + cands


_REGISTRY: dict[str, Layout] = {}


def register_layout(layout: Layout, *, overwrite: bool = False) -> Layout:
    if layout.name in _REGISTRY and not overwrite:
        raise ValueError(f"layout {layout.name!r} is already registered")
    _REGISTRY[layout.name] = layout
    return layout


def get_layout(name: str) -> Layout:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown layout {name!r}; valid: {sorted(_REGISTRY)}") from None


def layout_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


# ------------------------------------------------------------- instances

GROUP4 = register_layout(Layout(
    name="group4",
    n_lanes=4,
    loc=LOC,
    vacated=VACATED,
    lines_in_slot=LINES_IN_SLOT,
    lanes_in_slot=LANES_IN_SLOT,
    lane_level=LANE_LEVEL,
    candidates=CANDIDATES,
    pred_slot=PRED_SLOT,
    state_names=STATE_NAMES,
    description="Fig. 6 restricted mapping: 4 consecutive 64B lines, "
                "5 layout states, 3-bit CSI per group",
))

# CRAM-KV 2:1 page pairs: lanes A/B; the packed state puts both pages in
# slot 0 (one DMA, two pages — the paper's win), slot 1 vacated.
KV_PAIR = register_layout(Layout(
    name="kv-pair",
    n_lanes=2,
    loc=np.asarray([[0, 1], [0, 0]], np.int32),
    vacated=np.asarray([[0, 0], [0, 1]], bool),
    lines_in_slot=np.asarray([[1, 1], [2, 0]], np.int32),
    lanes_in_slot=np.asarray([[0b01, 0b10], [0b11, 0]], np.int32),
    lane_level=np.asarray([[0, 0], [1, 1]], np.int32),
    candidates=((0,), (1, 0)),
    pred_slot=np.asarray([[0, 0], [1, 0]], np.int32),
    state_names=("uncomp", "pair"),
    description="CRAM-KV 2:1 page-pair slots (int8-delta codec, marker in "
                "the base-strip tail lanes)",
))

# CRAM-KV 4:1 page quads: lanes A..D; the packed state puts all four pages
# in slot 0 (int4-delta codec), slots 1-3 vacated.
KV_QUAD = register_layout(Layout(
    name="kv-quad",
    n_lanes=4,
    loc=np.asarray([[0, 1, 2, 3], [0, 0, 0, 0]], np.int32),
    vacated=np.asarray([[0, 0, 0, 0], [0, 1, 1, 1]], bool),
    lines_in_slot=np.asarray([[1, 1, 1, 1], [4, 0, 0, 0]], np.int32),
    lanes_in_slot=np.asarray(
        [[0b0001, 0b0010, 0b0100, 0b1000], [0b1111, 0, 0, 0]], np.int32),
    lane_level=np.asarray([[0, 0, 0, 0], [2, 2, 2, 2]], np.int32),
    candidates=((0,), (1, 0), (2, 0), (3, 0)),
    pred_slot=np.asarray(
        [[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], np.int32),
    state_names=("uncomp", "quad"),
    description="CRAM-KV 4:1 page-quad slots (int4-delta codec)",
))


# ------------------------------------------- GROUP4 state-choice helpers

def choose_state(sizes, valid_mask: int = 0b1111, budget: int = PAYLOAD_BUDGET):
    """Best GROUP4 layout state for a group given per-line compressed sizes.

    sizes: 4 compressed sizes in bytes (including per-line headers).
    valid_mask: which lanes' data the controller actually holds (only lanes
      co-resident in the LLC may be packed together — ganged eviction).
    """
    s = [int(x) for x in sizes]
    have = lambda m: (valid_mask & m) == m
    quad = have(0b1111) and sum(s) <= budget
    ab = have(0b0011) and s[0] + s[1] <= budget
    cd = have(0b1100) and s[2] + s[3] <= budget
    if quad:
        return S_QUAD
    if ab and cd:
        return S_AB_CD
    if ab:
        return S_AB
    if cd:
        return S_CD
    return S_U


def fits_to_state(pair_ab: bool, pair_cd: bool, quad: bool) -> int:
    if quad:
        return S_QUAD
    if pair_ab and pair_cd:
        return S_AB_CD
    if pair_ab:
        return S_AB
    if pair_cd:
        return S_CD
    return S_U


def slot_of(state: int, lane: int) -> int:
    return GROUP4.slot_of(state, lane)


def probe_chain(lane: int, predicted_slot: int) -> list[int]:
    """GROUP4 probe order (see Layout.probe_chain for the generic form)."""
    return GROUP4.probe_chain(lane, predicted_slot)
