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


def state_diffs(a: TrainState, b: TrainState) -> dict:
    """How far train state ``a`` is from ``b``: for the model's state_dict
    (parameters and BatchNorm buffers) and for each AMSGrad moment, the
    largest absolute difference and the norm-wise relative one
    (||a - b|| / ||b|| over all the group's tensors)."""
    groups = {"model": (a.model.state_dict(), b.model.state_dict())}
    for m in ("mu", "nu", "nu_max"):
        groups[m] = (getattr(a.opt_state, m), getattr(b.opt_state, m))
    out = {}
    for name, (ga, gb) in groups.items():
        worst = sq_diff = sq_ref = 0.0
        for k, vb in gb.items():
            d = ga[k].double() - vb.double()
            worst = max(worst, d.abs().max().item())
            sq_diff += d.square().sum().item()
            sq_ref += vb.double().square().sum().item()
        out[name] = {"max_abs": worst,
                     "relative": (sq_diff / sq_ref) ** 0.5 if sq_ref else 0.0}
    return out
