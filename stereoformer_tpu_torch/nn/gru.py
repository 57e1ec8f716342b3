"""The z/b/g convolutional GRU cell (NCHW).

Counterpart of ``stereoformer_tpu/nn/gru.py::ConvGRU``. The JAX package
fuses the z and b gate convs into one ``conv_zb``; here they are the
reference's two convs ``conv_z`` and ``conv_b`` (the weight bridge splits
``conv_zb`` along its output channels, z first).

``dtype=torch.bfloat16``: the gate convs compute in bf16 (``nn/conv.py``),
and the hidden state starts at zeros of x's dtype and stays in it, as in
JAX: a bf16 x carries a bf16 state through every iteration; every
elementwise op rounds to bf16, the sigmoid as JAX expands it, and the
gates' gradients follow JAX's rules (``nn/bf16.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from . import bf16
from .conv import Conv


class ConvGRU(nn.Module):
    """z = sigmoid(conv_z([x, h])), b = sigmoid(conv_b([x, h])),
    g = tanh(conv_g([b*h, x])), h' = (1 - z)*h + z*g. The hidden state
    starts at zeros."""

    def __init__(self, input_dim: int, hidden_dim: int, dtype=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.conv_z = Conv(input_dim + hidden_dim, hidden_dim, 3, dtype=dtype)
        self.conv_b = Conv(input_dim + hidden_dim, hidden_dim, 3, dtype=dtype)
        self.conv_g = Conv(hidden_dim + input_dim, hidden_dim, 3, dtype=dtype)

    def forward(self, x, h=None):
        if h is None:
            h = x.new_zeros((x.shape[0], self.hidden_dim, *x.shape[2:]))
        xh = torch.cat([x, h], dim=1)
        z = bf16.sigmoid(self.conv_z(xh))
        b = bf16.sigmoid(self.conv_b(xh))
        g = bf16.tanh(self.conv_g(torch.cat([b * h, x], dim=1)))
        return (1.0 - z) * h + z * g
