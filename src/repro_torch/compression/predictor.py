"""The line-location predictor (LLP, §V-B), copied from
`repro.compression.predictor`.

A Last Compressibility Table (LCT) records, per indexed entry, the last
compressibility level observed; predicting the level predicts the slot to
probe through the layout's `pred_slot` table, and the layout's
candidate-slot table bounds the probe walk.  Two deployments:

  * the memory-system LLP — 512 entries indexed by a Fibonacci hash of the
    page address, predicting over layouts.GROUP4
    (`probe_count_table(GROUP4)` is the trace engine's PROBE table; `LLP`
    is the functional model's host object);
  * the KV predictor — one entry per page group, indexed directly
    (`observe_layout`).
"""

from __future__ import annotations

import numpy as np
import torch

from .framing import FIB_MULT
from .layouts import Layout

LCT_ENTRIES = 512
LINES_PER_PAGE = 64  # 4KB page / 64B lines

HASH_MULT = FIB_MULT  # Fibonacci hashing (the golden multiplier, framing.py)
_HASH_MULT = HASH_MULT  # legacy alias


def page_of(line_addr):
    return line_addr // LINES_PER_PAGE


def lct_index(page, n_entries: int = LCT_ENTRIES):
    return ((page * HASH_MULT) & 0xFFFFFFFF) % n_entries


class LLP:
    """Host-side predictor used by the exact functional model."""

    def __init__(self, n_entries: int = LCT_ENTRIES):
        self.n_entries = n_entries
        self.lct = np.zeros(n_entries, dtype=np.int8)
        self.predictions = 0
        self.correct = 0

    def predict_level(self, line_addr: int) -> int:
        return int(self.lct[lct_index(page_of(line_addr), self.n_entries)])

    def update(self, line_addr: int, observed_level: int) -> None:
        self.lct[lct_index(page_of(line_addr), self.n_entries)] = observed_level

    def record_outcome(self, was_correct: bool) -> None:
        self.predictions += 1
        self.correct += int(was_correct)

    @property
    def accuracy(self) -> float:
        return self.correct / self.predictions if self.predictions else 1.0

    @property
    def storage_bytes(self) -> int:
        return self.n_entries * 2 // 8  # 2 bits/entry as in Table III


# -- pure-function variants (numpy arrays or torch tensors) -----------------

def llp_predict(lct, line_addr, xp):
    idx = lct_index(page_of(line_addr), lct.shape[0])
    return lct[idx]


def llp_update(lct, line_addr, level, xp):
    """A new table with the entry of `line_addr`'s page set to `level`;
    `xp` is numpy or torch, as the reference takes numpy or jax.numpy."""
    idx = lct_index(page_of(line_addr), lct.shape[0])
    lct = lct.copy() if xp is np else lct.clone()
    lct[idx] = level
    return lct


# -- layout-parameterized probe accounting ----------------------------------

def probe_count_table(layout: Layout) -> np.ndarray:
    """PROBE[state, lane, predicted_level] -> accesses to locate the line.

    Lane 0 never moves (one probe); other lanes walk the layout's probe
    chain starting at the slot `pred_slot[lane, level]` resolves to.  This
    is the dense table the trace engine indexes per miss.
    """
    n_states, n_lanes = layout.loc.shape
    n_levels = layout.pred_slot.shape[1]
    t = np.zeros((n_states, n_lanes, n_levels), dtype=np.int32)
    for st in range(n_states):
        for lane in range(n_lanes):
            for lvl in range(n_levels):
                pred = int(layout.pred_slot[lane][lvl]) if lane else 0
                chain = layout.probe_chain(lane, pred) if lane else [0]
                t[st, lane, lvl] = chain.index(int(layout.loc[st][lane])) + 1
    return t


def observe_layout(observed_state: torch.Tensor) -> torch.Tensor:
    """Direct-indexed last-compressibility update: one entry per page
    group, hash = identity, so the next access predicts whatever layout
    the group last packed into.  Returns a fresh buffer, because the
    observed layout is updated in place by the next repack."""
    return observed_state.clone()
