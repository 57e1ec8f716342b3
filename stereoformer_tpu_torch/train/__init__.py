"""Training of the port: state, AMSGrad, schedules and the steps."""

from .optim import Amsgrad, AmsgradState
from .schedule import make_step_schedule, reference_lr
from .state import TrainState
from .steps import (
    LOSS_NAMES,
    compute_loss,
    make_eval_step,
    make_infer_fn,
    make_train_step,
)

__all__ = [
    "Amsgrad",
    "AmsgradState",
    "LOSS_NAMES",
    "TrainState",
    "compute_loss",
    "make_eval_step",
    "make_infer_fn",
    "make_step_schedule",
    "make_train_step",
    "reference_lr",
]
