"""Soft-argmin disparity regression, the root variance around a disparity,
and the GRU's uncertainty volume.

Counterpart of ``stereoformer_tpu/ops/softargmin.py``. Volumes are
``[B, H, W, D]`` with D innermost.
"""

from __future__ import annotations

import torch


def soft_argmin(cost_volume: torch.Tensor) -> torch.Tensor:
    """Disparity expectation under softmax over D: [B, H, W, D] -> [B, H, W]."""
    prob = torch.softmax(cost_volume, dim=-1)
    d = torch.arange(cost_volume.shape[-1], dtype=prob.dtype,
                     device=prob.device)
    return (prob * d).sum(-1)


def disparity_variance(prob_volume: torch.Tensor,
                       cur_disp: torch.Tensor) -> torch.Tensor:
    """sqrt(sum_d p_d (d - mu)^2) around the current disparity mu: prob
    [B, H, W, D], cur_disp [B, H, W] or [B, H, W, 1] -> [B, H, W, 1]."""
    cur = cur_disp if cur_disp.dim() == prob_volume.dim() else cur_disp[..., None]
    d = torch.arange(prob_volume.shape[-1], dtype=prob_volume.dtype,
                     device=prob_volume.device)
    return (prob_volume * (d - cur) ** 2).sum(-1, keepdim=True).sqrt()


def uncertainty_volume(prob_volume: torch.Tensor,
                       cur_disp: torch.Tensor) -> torch.Tensor:
    """p_d * d * (d - mu)^2 per disparity bin, the GRU's guidance input.
    prob [B, H, W, D], cur_disp [B, H, W, 1] -> [B, H, W, D]."""
    d = torch.arange(prob_volume.shape[-1], dtype=prob_volume.dtype,
                     device=prob_volume.device)
    return prob_volume * d * (d - cur_disp) ** 2
