"""AMSGrad in optax's order.

Counterpart of ``optax.amsgrad`` (optax 0.2.6: ``scale_by_amsgrad`` then
``scale_by_learning_rate``), which the JAX package trains with. Per
parameter, with the step count n after the increment:

    mu     = b1 * mu + (1 - b1) * g
    nu     = b2 * nu + (1 - b2) * g^2
    nu_max = max(nu_max, nu / (1 - b2^n))       # after bias correction
    p     -= lr(n - 1) * (mu / (1 - b1^n)) / (sqrt(nu_max) + eps)

The learning rate comes from the schedule at the count before the
increment. ``torch.optim.Adam(amsgrad=True)`` takes the maximum before bias
correction, so its trajectory differs from this one.

Under FSDP (``parallel.shard_state_fsdp``) the parameters, their gradients
and the moments are ``DTensor``s of one sharding: the update runs on each
rank's shards, elementwise as above.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch

from ..parallel.fsdp import local_tensor


@dataclass
class AmsgradState:
    """optax's ``ScaleByAmsgradState``: the step count and three moments,
    each a dict of tensors keyed by parameter name."""

    count: int
    mu: dict
    nu: dict
    nu_max: dict


class Amsgrad:
    """``learning_rate`` is a float or a schedule, step count -> float.

    ``trainable``, a predicate on parameter names, masks the update as
    ``optax.multi_transform`` with ``set_to_zero`` does (the JAX package's
    ``train/params.py::masked_optimizer``): a parameter it rejects is left
    as it is and its moments stay zero; the count moves on for all."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 trainable: Optional[Callable[[str], bool]] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.trainable = trainable

    def init(self, params: Mapping[str, torch.Tensor]) -> AmsgradState:
        """Zero moments, each of its parameter's shape, device and
        sharding."""
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}

        return AmsgradState(count=0, mu=zeros(), nu=zeros(), nu_max=zeros())

    @torch.no_grad()
    def step(self, state: AmsgradState, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> None:
        """Update ``params`` and ``state`` in place from ``grads``."""
        lr = self.learning_rate
        if callable(lr):
            lr = lr(state.count)
        n = state.count + 1
        b1, b2 = self.b1, self.b2
        c1, c2 = _bias_correction(b1, n), _bias_correction(b2, n)
        for k, p in params.items():
            if self.trainable is not None and not self.trainable(k):
                continue
            g = local_tensor(grads[k])
            mu = local_tensor(state.mu[k]).mul_(b1).add_(g, alpha=1 - b1)
            nu = local_tensor(state.nu[k]).mul_(b2).addcmul_(g, g,
                                                             value=1 - b2)
            nu_max = local_tensor(state.nu_max[k])
            torch.maximum(nu_max, nu / c2, out=nu_max)
            local_tensor(p).add_((mu / c1) / (nu_max.sqrt() + self.eps),
                                 alpha=-lr)
        state.count = n


def _bias_correction(decay: float, n: int) -> float:
    """1 - decay^n in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(n))
