"""Disparity error metrics.

Counterpart of ``stereoformer_tpu/metrics.py``. Under a data-parallel
``group`` (None by default), whose ranks hold the rows of one global batch,
each metric is the global batch's, on every rank.
"""

from __future__ import annotations

import torch

from .parallel.distributed import global_sum, group_size


def _global_mean(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x.mean()
    return global_sum(x.sum(), group) / (x.numel() * group_size(group))


def d1_metric(pred: torch.Tensor, gt: torch.Tensor,
              group=None) -> torch.Tensor:
    """Fraction of pixels whose error is above 3 px and above 5% of |gt|
    (a mean over all pixels)."""
    e = (pred - gt).abs()
    bad = (e > 3.0) & (e / gt.abs() > 0.05)
    return _global_mean(bad.float(), group)


def p1_metric(pred: torch.Tensor, gt: torch.Tensor,
              group=None) -> torch.Tensor:
    """Fraction of pixels whose error is above 1 px."""
    return _global_mean(((pred - gt).abs() > 1.0).float(), group)


def thres_metric(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                 thres: float, group=None) -> torch.Tensor:
    """Fraction of the masked pixels whose error is above ``thres``."""
    m = mask.float()
    bad = ((pred - gt).abs() > thres).float()
    return (global_sum((bad * m).sum(), group)
            / global_sum(m.sum(), group).clamp(min=1.0))
