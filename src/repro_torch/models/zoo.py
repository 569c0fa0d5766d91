"""Model construction (port of `repro.models.zoo.build`, dense family)."""

from __future__ import annotations

import torch

from ..device import resolve_device
from .common import ModelConfig
from .transformer import DenseLM, init_lm


def build(cfg: ModelConfig, *, device="cuda", seed: int = 0,
          params: dict[str, torch.Tensor] | None = None) -> DenseLM:
    """The model on `device`: random weights from a `torch.Generator`
    seeded with `seed`, or `params` (a state dict, e.g. from
    `repro_torch.convert.params_from_jax`)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r}: not ported yet")
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = init_lm(cfg, gen, dev)
    else:
        params = {k: v.to(device=dev, dtype=cfg.param_dtype)
                  for k, v in params.items()}
    return DenseLM(cfg, params)
