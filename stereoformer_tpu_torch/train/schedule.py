"""Learning-rate schedules.

Counterpart of ``stereoformer_tpu/train/schedule.py``. ``reference_lr`` is
the reference trainer's per-epoch rate: constant for epochs 0..19, then
lr / ((epoch - 10) // 10 * 2): epochs 20-29 -> lr/2, 30-39 -> lr/4,
40-49 -> lr/6, ...
"""

from __future__ import annotations


def reference_lr(base_lr: float, epoch: int) -> float:
    """The reference trainer's learning rate at ``epoch``."""
    if epoch > 19:
        return base_lr / max((epoch - 10) // 10 * 2, 1)
    return base_lr


def make_step_schedule(base_lr: float, steps_per_epoch: int):
    """A schedule for ``optim.Amsgrad``: step count -> the reference rate of
    that step's epoch."""

    def schedule(step: int) -> float:
        return reference_lr(base_lr, step // max(steps_per_epoch, 1))

    return schedule
