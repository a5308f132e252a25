from .optim import make_lr_schedule, make_optimizer, optimizer_step
from .step import (
    DeviceBatch,
    TrainState,
    canonicalize,
    init_params,
    init_state,
    make_eval_forward,
    make_loss_and_grads,
    make_train_step,
    panoptic_forward,
)

__all__ = [
    "DeviceBatch", "TrainState", "canonicalize", "init_params", "init_state",
    "make_eval_forward", "make_loss_and_grads", "make_lr_schedule", "make_optimizer",
    "make_train_step", "optimizer_step", "panoptic_forward",
]
