"""Training state.

Counterpart of ``stereoformer_tpu/train/state.py::TrainState``: the step
count, the model (its parameters and BatchNorm buffers, which the JAX
package keeps as ``params`` and ``batch_stats``) and the optimizer state.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from .optim import Amsgrad, AmsgradState


@dataclass
class TrainState:
    step: int
    model: nn.Module
    opt_state: AmsgradState

    @classmethod
    def create(cls, model: nn.Module, tx: Amsgrad) -> "TrainState":
        """Step 0 and ``tx``'s initial state for the model's parameters."""
        return cls(step=0, model=model,
                   opt_state=tx.init(dict(model.named_parameters())))
