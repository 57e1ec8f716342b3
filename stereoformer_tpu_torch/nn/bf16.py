"""Elementwise ops where JAX rounds a bf16 result differently from torch.

In a bf16 module XLA expands ``jax.nn.sigmoid`` to 1 / (1 + exp(-x)) and
rounds to bf16 after the exp, the add and the division; torch's bf16
sigmoid rounds once. ``jax.nn.leaky_relu(x, 0.1)`` multiplies by the slope
cast to bf16 (0.10009765625); torch's by 0.1. These give the JAX values for
a bf16 x and torch's own ops for any other dtype.

The gradients of the sigmoid and of tanh are JAX's default rules for
``lax.logistic`` and ``lax.tanh``, each op rounded to bf16:
g * (s * (1 - s)) for s = sigmoid(x), and e + e * t with e = g * (1 - t)
for t = tanh(x) (the transpose of JAX's (g + g*t) * (1 - t)). Autograd of
the expansion would multiply by exp(-x), which is inf in bf16 below
x = -88.7, and give NaN where the sigmoid is 0; torch's tanh backward
computes g * (1 - t*t) and rounds once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        t = torch.tanh(x)
        ctx.save_for_backward(t)
        return t

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        e = g * (1.0 - t)
        return e + e * t


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return _Sigmoid.apply(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return torch.tanh(x)
    return _Tanh.apply(x)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))
