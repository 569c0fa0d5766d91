"""The optimizer and the train step (port of `repro.optim`; the gradient
compression of `grad_compress.py` comes with the sharding slice)."""

from .adamw import (TrainState, adamw_init, adamw_update, cosine_lr,
                    global_norm, make_train_step)

__all__ = ["TrainState", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "make_train_step"]
