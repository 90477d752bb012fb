"""Training substrate: AdamW, the train step, microbatching, and the
fault-tolerant controller."""

from .optimizer import OptimizerConfig, adamw_update, global_norm, init_opt_state, lr_at
from .train_step import cast_params_for_compute, make_train_step

__all__ = [
    "OptimizerConfig",
    "adamw_update",
    "global_norm",
    "init_opt_state",
    "lr_at",
    "cast_params_for_compute",
    "make_train_step",
]
