"""The dense decoder of the model zoo (port of the dense part of
`repro.models`)."""

from .common import ModelConfig, smoke_config
from .transformer import DenseLM, init_cache, init_lm, lm_decode_step
from .zoo import build

__all__ = ["ModelConfig", "DenseLM", "build", "init_cache", "init_lm",
           "lm_decode_step", "smoke_config"]
