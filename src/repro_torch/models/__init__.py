"""The model zoo (port of `repro.models`): the decoder families (dense,
moe, ssm, hybrid, vlm) and whisper's encoder-decoder (encdec), their
training forward and loss and their decode step."""

from .common import ModelConfig, smoke_config
from .transformer import (DecoderLM, init_cache, init_lm, init_lm_reference,
                          lm_decode_step, lm_forward, lm_loss)
from .whisper import Whisper, init_whisper
from .zoo import (SHAPES_BY_NAME, STANDARD_SHAPES, ShapeSpec,
                  abstract_params, active_params, build, cache_specs,
                  count_params, input_specs, param_axes)

__all__ = ["ModelConfig", "DecoderLM", "SHAPES_BY_NAME", "STANDARD_SHAPES",
           "ShapeSpec", "Whisper", "abstract_params", "active_params",
           "build", "cache_specs", "count_params", "init_cache", "init_lm",
           "init_lm_reference", "init_whisper", "input_specs",
           "lm_decode_step", "lm_forward", "lm_loss", "param_axes",
           "smoke_config"]
