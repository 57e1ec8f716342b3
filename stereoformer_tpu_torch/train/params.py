"""Parameter utilities: counting, and the optimizer masks of the
deformable conv's offset convs.

Counterpart of ``stereoformer_tpu/train/params.py``. The JAX package masks
an optax transformation by parameter path; here the mask is a predicate on
the ``state_dict`` names of ``Amsgrad(trainable=...)``.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from .optim import Amsgrad


def count_parameters(model: nn.Module) -> int:
    """The number of scalar parameters."""
    return sum(p.numel() for p in model.parameters())


def masked_optimizer(tx: Amsgrad, trainable: Callable[[str], bool]) -> Amsgrad:
    """``tx``'s AMSGrad that updates only the parameters whose name
    satisfies ``trainable``; the others keep their values and zero
    moments."""
    return Amsgrad(tx.learning_rate, tx.b1, tx.b2, tx.eps,
                   trainable=trainable)


def is_offset_param(path: str) -> bool:
    """The deformable convs' offset and mask convs (``conv_offset_mask``,
    e.g. ``local_cost_volume.unet.deformblock.conv2.conv_offset_mask``)."""
    return "offset_mask" in path


def freeze_offsets(tx: Amsgrad) -> Amsgrad:
    """Train everything but the offset convs. (The JAX function also takes
    the parameter tree, to label it; this mask reads names only.)"""
    return masked_optimizer(tx, lambda p: not is_offset_param(p))


def only_offsets(tx: Amsgrad) -> Amsgrad:
    """Train only the offset convs."""
    return masked_optimizer(tx, is_offset_param)
