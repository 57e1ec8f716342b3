"""Training of the port: state, AMSGrad, schedules, the steps, checkpoints
and the trainer."""

from .checkpoint import (
    checkpoint_meta,
    finalize_checkpoints,
    latest_checkpoint,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from .optim import Amsgrad, AmsgradState
from .params import count_parameters, freeze_offsets, only_offsets
from .schedule import make_step_schedule, reference_lr
from .state import TrainState, state_diffs
from .steps import (
    LOSS_NAMES,
    compute_loss,
    make_eval_step,
    make_infer_fn,
    make_train_step,
)
from .trainer import DisparityTrainer

__all__ = [
    "Amsgrad",
    "AmsgradState",
    "DisparityTrainer",
    "LOSS_NAMES",
    "TrainState",
    "checkpoint_meta",
    "compute_loss",
    "count_parameters",
    "finalize_checkpoints",
    "freeze_offsets",
    "latest_checkpoint",
    "make_eval_step",
    "make_infer_fn",
    "make_step_schedule",
    "make_train_step",
    "only_offsets",
    "reference_lr",
    "restore_checkpoint",
    "restore_params",
    "save_checkpoint",
    "state_diffs",
]
