"""BatchNorm with Flax's train semantics (NCHW).

Counterpart of ``flax.linen.BatchNorm(momentum=0.9)`` as the JAX package's
blocks use it (``stereoformer_tpu/nn/blocks.py``): in train mode it
normalises with the batch mean and the biased batch variance, gradients
flowing through both, and moves the running statistics by 0.1 towards the
batch's, the variance being the *biased* one, as Flax's is. torch's own
``BatchNorm2d`` moves ``running_var`` towards the unbiased variance. In eval
mode it normalises with the running statistics. The parameters and buffers
are ``nn.BatchNorm2d``'s, so ``state_dict`` keys do not change.

``dtype`` is Flax's ``BatchNorm(dtype=...)``: the output's dtype. The
normalisation ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` is computed
in float32 against the float32 statistics, whatever x's dtype, and only the
result is cast (``flax.linen.normalization._normalize``); torch's own bf16
batch norm would compute in bf16. With ``dtype=None`` the output is float32
for a float32 x, as before; a float64 x (a float64 reference, with the
module's parameters in float64) is normalised in float64.

``frozen_statistics(model)`` keeps the running statistics of every such
norm in ``model`` as they are while it is active: the recompute of a
checkpointed forward (``remat``) runs each norm in train mode a second time,
and the statistics must move once per step, as under ``jax.checkpoint``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from .conv import check_dtype


class BatchNorm2d(nn.BatchNorm2d):
    """eps 1e-5 and momentum 0.1 (Flax's 0.9), over every axis but the
    channels' (N, H and W; N, D, H and W for a 3-D volume)."""

    def __init__(self, num_features: int, dtype=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.update_statistics = True
        self.out_dtype = check_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.out_dtype is not None or x.dtype not in (torch.float32,
                                                          torch.float64):
            # a channels_last x gives a channels_last output, as the routed
            # convs that read it need, also where N = 1 leaves its layout
            # ambiguous (the card's train-mode batch norm then casts to
            # NCHW)
            fmt = (torch.channels_last if x.dim() == 4 and
                   x.is_contiguous(memory_format=torch.channels_last)
                   else torch.preserve_format)
            return self._forward(x.float()).to(
                self.out_dtype or torch.promote_types(x.dtype, torch.float32),
                memory_format=fmt)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and self.out_dtype is not None:
            # Flax's order of operations, so that the one rounding to the
            # output dtype sees the same float32 value
            s = torch.rsqrt(self.running_var + self.eps) * self.weight
            c = (-1,) + (1,) * (x.dim() - 2)
            return ((x - self.running_mean.view(c)) * s.view(c)
                    + self.bias.view(c))
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # training=True with no running buffers: batch statistics, with
        # their gradient; the buffers are moved below, outside autograd
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        if not self.update_statistics:
            return out
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, *range(2, x.dim())),
                                       correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return out


@contextlib.contextmanager
def frozen_statistics(model: nn.Module):
    """Train-mode ``BatchNorm2d`` layers of ``model`` normalise with the
    batch's statistics but leave their running statistics unchanged while
    this is active."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.update_statistics = False
    try:
        yield
    finally:
        for m in norms:
            m.update_statistics = True
