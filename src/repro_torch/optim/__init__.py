"""The optimizer and the train step (port of `repro.optim`), and the
gated compressed-gradient DP step (`grad_compress`)."""

from .adamw import (TrainState, abstract_opt_state, adamw_init,
                    adamw_update, cosine_lr, global_norm, make_train_step)

__all__ = ["TrainState", "abstract_opt_state", "adamw_init", "adamw_update",
           "cosine_lr", "global_norm", "make_train_step"]
