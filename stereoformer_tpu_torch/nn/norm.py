"""BatchNorm with Flax's train semantics (NCHW).

Counterpart of ``flax.linen.BatchNorm(momentum=0.9)`` as the JAX package's
blocks use it (``stereoformer_tpu/nn/blocks.py``): in train mode it
normalises with the batch mean and the biased batch variance, gradients
flowing through both, and moves the running statistics by 0.1 towards the
batch's, the variance being the *biased* one, as Flax's is. torch's own
``BatchNorm2d`` moves ``running_var`` towards the unbiased variance. In eval
mode it normalises with the running statistics. The parameters and buffers
are ``nn.BatchNorm2d``'s, so ``state_dict`` keys do not change.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """eps 1e-5 and momentum 0.1 (Flax's 0.9), over N, H and W."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # training=True with no running buffers: batch statistics, with
        # their gradient; the buffers are moved below, outside autograd
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out
