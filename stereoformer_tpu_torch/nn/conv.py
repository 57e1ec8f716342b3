"""``Conv``: the JAX package's ``nn/conv.py::Conv`` forward as ``nn.Conv2d``.

The JAX modules of this slice pad every convolution symmetrically by
(k - 1) // 2, which is what ``nn.Conv2d`` does with an integer padding.
"""

from __future__ import annotations

from torch import nn


def Conv(in_channels: int, out_channels: int, kernel_size: int,
         stride: int = 1, bias: bool = True) -> nn.Conv2d:
    """A k x k convolution (NCHW) padded by (k - 1) // 2 on every side."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                     padding=(kernel_size - 1) // 2, bias=bias)
