"""The KV last-compressibility predictor (the LLP analog), copied from
`repro.compression.predictor.observe_layout`."""

from __future__ import annotations

import torch


def observe_layout(observed_state: torch.Tensor) -> torch.Tensor:
    """Direct-indexed last-compressibility update: one entry per page
    group, hash = identity, so the next access predicts whatever layout
    the group last packed into.  Returns a fresh buffer, because the
    observed layout is updated in place by the next repack."""
    return observed_state.clone()
