"""Disparity error metrics.

Counterpart of ``stereoformer_tpu/metrics.py``.
"""

from __future__ import annotations

import torch


def d1_metric(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Fraction of pixels whose error is above 3 px and above 5% of |gt|
    (a mean over all pixels)."""
    e = (pred - gt).abs()
    bad = (e > 3.0) & (e / gt.abs() > 0.05)
    return bad.float().mean()


def p1_metric(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Fraction of pixels whose error is above 1 px."""
    return ((pred - gt).abs() > 1.0).float().mean()


def thres_metric(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                 thres: float) -> torch.Tensor:
    """Fraction of the masked pixels whose error is above ``thres``."""
    m = mask.float()
    bad = ((pred - gt).abs() > thres).float()
    return (bad * m).sum() / m.sum().clamp(min=1.0)
