"""Elementwise ops where JAX rounds a bf16 result differently from torch.

In a bf16 module XLA expands ``jax.nn.sigmoid`` to 1 / (1 + exp(-x)) and
rounds to bf16 after the exp, the add and the division; torch's bf16
sigmoid rounds once. ``jax.nn.leaky_relu(x, 0.1)`` multiplies by the slope
cast to bf16 (0.10009765625); torch's by 0.1. These give the JAX values for
a bf16 x and torch's own ops for any other dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))
