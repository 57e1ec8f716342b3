"""The z/b/g convolutional GRU cell (NCHW).

Counterpart of ``stereoformer_tpu/nn/gru.py::ConvGRU``. The JAX package
fuses the z and b gate convs into one ``conv_zb``; here they are the
reference's two convs ``conv_z`` and ``conv_b`` (the weight bridge splits
``conv_zb`` along its output channels, z first).
"""

from __future__ import annotations

import torch
from torch import nn

from .conv import Conv


class ConvGRU(nn.Module):
    """z = sigmoid(conv_z([x, h])), b = sigmoid(conv_b([x, h])),
    g = tanh(conv_g([b*h, x])), h' = (1 - z)*h + z*g. The hidden state
    starts at zeros."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.conv_z = Conv(input_dim + hidden_dim, hidden_dim, 3)
        self.conv_b = Conv(input_dim + hidden_dim, hidden_dim, 3)
        self.conv_g = Conv(hidden_dim + input_dim, hidden_dim, 3)

    def forward(self, x, h=None):
        if h is None:
            h = x.new_zeros((x.shape[0], self.hidden_dim, *x.shape[2:]))
        xh = torch.cat([x, h], dim=1)
        z = torch.sigmoid(self.conv_z(xh))
        b = torch.sigmoid(self.conv_b(xh))
        g = torch.tanh(self.conv_g(torch.cat([b * h, x], dim=1)))
        return (1.0 - z) * h + z * g
