"""The decoder families of the model zoo (port of `repro.models`: dense,
moe, ssm, hybrid and vlm, their training forward and loss and their
decode step; whisper's encdec is not ported yet)."""

from .common import ModelConfig, smoke_config
from .transformer import (DecoderLM, init_cache, init_lm, init_lm_reference,
                          lm_decode_step, lm_forward, lm_loss)
from .zoo import active_params, build, count_params

__all__ = ["ModelConfig", "DecoderLM", "active_params", "build",
           "count_params", "init_cache", "init_lm", "init_lm_reference",
           "lm_decode_step", "lm_forward", "lm_loss", "smoke_config"]
