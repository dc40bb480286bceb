"""Training of the port: AdamW (``optimizer``) and the train step with
its loss and microbatch accumulation (``train_step``)."""

from .optimizer import OptConfig, adamw_init, adamw_update, global_norm, lr_at
from .train_step import AUX_LOSS_WEIGHT, init_train_state, loss_fn, make_train_step

__all__ = ["AUX_LOSS_WEIGHT", "OptConfig", "adamw_init", "adamw_update", "global_norm",
           "init_train_state", "loss_fn", "lr_at", "make_train_step"]
