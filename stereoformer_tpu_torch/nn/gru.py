"""Convolutional GRU cells (NCHW): the z/b/g cell and RAFT's separable cell.

Counterparts of ``stereoformer_tpu/nn/gru.py::ConvGRU`` and ``SepConvGRU``.
The JAX package fuses the z and b gate convs into one ``conv_zb``; here
they are the reference's two convs ``conv_z`` and ``conv_b`` (the weight
bridge splits ``conv_zb`` along its output channels, z first).

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


class SepConvGRU(nn.Module):
    """RAFT's separable ConvGRU: a gated update with 1x5 convs, then one
    with 5x1 convs, each z = sigmoid(convz([h, x])), r = sigmoid(convr([h,
    x])), q = tanh(convq([r*h, x])), h' = (1 - z)*h + z*q; float32. Keys
    ``convz1``, ``convr1``, ``convq1`` (1x5) and ``convz2``, ``convr2``,
    ``convq2`` (5x1), the reference's: the JAX cell fuses each direction's
    z and r convs into ``convzr1``/``convzr2``, which the weight bridge
    splits, z first."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 192 + 128):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}",
                        nn.Conv2d(cin, hidden_dim, k, padding=pad))

    def forward(self, h, x):
        for suffix in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, "convz" + suffix)(hx))
            r = torch.sigmoid(getattr(self, "convr" + suffix)(hx))
            q = torch.tanh(getattr(self, "convq" + suffix)(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h
