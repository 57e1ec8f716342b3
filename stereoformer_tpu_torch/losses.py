"""Losses and error metrics over [B, H, W(, 1)] tensors.

Counterpart of ``stereoformer_tpu/losses/__init__.py``, function by
function. ``sequence_loss`` takes, as the reference does, the mean over *all*
pixels of the masked difference: masked-out pixels add zeros to the
numerator and count in the denominator. Masks are multiplications, not
boolean indexing, as in the JAX package.

``group`` (every function's last argument, None by default) is a
data-parallel process group whose ranks hold the rows of one global batch,
as ``train.make_train_step(..., mesh=)`` runs them. JAX computes each loss
on the global batch, so a masked mean is ``Σ_global(v·m) / Σ_global(m)``
and a plain mean divides by the global pixel count. Here each rank returns
its *share* of the global loss, ``Σ_local(v·m) / Σ_global(m)``: the shares
sum to the global loss, and the gradients summed over the ranks are the
global loss's. Only the denominators are all-reduced, outside autograd
(no mask has a gradient). ``epe`` is a metric and comes back global.
Without a group every function computes as before.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .ops import resize_bilinear
from .parallel.distributed import global_sum, group_size

MAX_DISP = 192.0


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _masked_mean(values: torch.Tensor, mask: torch.Tensor,
                 group=None) -> torch.Tensor:
    mask = mask.to(values.dtype)
    return (values * mask).sum() / global_sum(mask.sum(), group).clamp(
        min=1.0)


def _mean(values: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the global batch's elements; this rank's share of it
    under a group (ranks hold equal shapes)."""
    if group is None:
        return values.mean()
    return values.sum() / (values.numel() * group_size(group))


def valid_mask(gt: torch.Tensor, lo_inclusive: bool = False) -> torch.Tensor:
    """0 < gt < 192 (0 <= gt < 192 for the 'equal' losses)."""
    lo = gt >= 0 if lo_inclusive else gt > 0
    return lo & (gt < MAX_DISP)


def epe(pred: torch.Tensor, gt: torch.Tensor, group=None) -> torch.Tensor:
    """Masked end-point error: mean |pred - gt| over 0 < gt < 192 (over the
    global batch, on every rank, under a group)."""
    return global_sum(_masked_mean((pred - gt).abs(), valid_mask(gt), group),
                      group)


def smooth_l1_masked(pred: torch.Tensor, gt: torch.Tensor,
                     mask: torch.Tensor, group=None) -> torch.Tensor:
    return _masked_mean(_smooth_l1(pred - gt), mask, group)


def sequence_loss(preds: Sequence[torch.Tensor], gt: torch.Tensor,
                  gamma: float = 0.8, group=None) -> torch.Tensor:
    """Exponentially weighted L1 over the GRU's outputs: the i-th of n
    weighs gamma^(n-i-1), each term mean(|pred*m - gt*m|) over all pixels."""
    n = len(preds)
    m = valid_mask(gt).to(gt.dtype)
    total = 0.0
    for i, p in enumerate(preds):
        total = total + gamma ** (n - i - 1) * _mean((p * m - gt * m).abs(),
                                                     group)
    return total


def single_scale_loss(pred: torch.Tensor, gt: torch.Tensor,
                      group=None) -> torch.Tensor:
    """Smooth-L1 over 0 < gt < 192; a low-resolution prediction is resized
    bilinearly to gt's size and scaled by the integer width ratio."""
    if pred.shape[-2] != gt.shape[-2]:
        scale = gt.shape[-2] // pred.shape[-2]
        pred = resize_bilinear(pred, gt.shape[-3:-1],
                               align_corners=False) * scale
    return smooth_l1_masked(pred, gt, valid_mask(gt), group)


def multi_scale_loss(preds: Sequence[torch.Tensor], gt: torch.Tensor,
                     weights: Sequence[float], group=None) -> torch.Tensor:
    """Weighted smooth-L1 over a prediction list, mask 0 < gt < 192."""
    m = valid_mask(gt)
    return sum(w * smooth_l1_masked(p, gt, m, group)
               for p, w in zip(preds, weights))


def multi_equal_loss(preds: Sequence[torch.Tensor], gt: torch.Tensor,
                     weights: Sequence[float] = (0.8, 1.2),
                     group=None) -> torch.Tensor:
    """Weighted smooth-L1 over a prediction list, mask 0 <= gt < 192."""
    m = valid_mask(gt, lo_inclusive=True)
    return sum(w * smooth_l1_masked(p, gt, m, group)
               for p, w in zip(preds, weights))


def searching_range_loss(pred_disp: torch.Tensor, gt_disp: torch.Tensor,
                         lower_map: torch.Tensor, upper_map: torch.Tensor,
                         alpha: float = 0.9, group=None) -> torch.Tensor:
    """Penalises gt outside [pred - lower, pred + upper], plus an
    alpha-blended range-width term. All inputs at one (1/8) scale; gt_disp
    already downscaled."""
    lower_t = pred_disp - lower_map
    upper_t = pred_disp + upper_map
    low_bad = (lower_t - gt_disp > 0).to(gt_disp.dtype)
    up_bad = (gt_disp - upper_t > 0).to(gt_disp.dtype)
    loss_lower = ((lower_t - gt_disp) * low_bad).abs().sum() / (
        global_sum(low_bad.sum(), group) + 1e-8)
    loss_upper = ((upper_t - gt_disp) * up_bad).abs().sum() / (
        global_sum(up_bad.sum(), group) + 1e-8)
    width = _mean((upper_t - lower_t).abs(), group)
    return alpha * (loss_lower + loss_upper) + (1.0 - alpha) * width


def total_loss(pred_disp: torch.Tensor, gt_disp: torch.Tensor,
               lower_map: Optional[torch.Tensor] = None,
               upper_map: Optional[torch.Tensor] = None,
               disp_low: Optional[torch.Tensor] = None,
               alpha: float = 0.9, disp_emphasis: float = 3.0,
               disp_only: bool = False, group=None) -> torch.Tensor:
    """disp_emphasis * smooth-L1 + the searching-range loss at 1/8."""
    d = single_scale_loss(pred_disp, gt_disp, group)
    if disp_only:
        return d
    gt8 = resize_bilinear(gt_disp, disp_low.shape[1:3],
                          align_corners=False) / 8.0
    r = searching_range_loss(disp_low, gt8, lower_map, upper_map, alpha=alpha,
                             group=group)
    return d * disp_emphasis + r


def range_and_disparity_loss(preds: Sequence[torch.Tensor], gt: torch.Tensor,
                             disp_low: torch.Tensor,
                             lower_bound: torch.Tensor,
                             upper_bound: torch.Tensor, gamma: float = 0.9,
                             weights: Sequence[float] = (0.8, 1.2),
                             group=None) -> torch.Tensor:
    """The supervised range loss at 1/8 scale, times 4, plus the equal loss.

    Keeps the reference's valid mask, ``upper_bound >= W - 1`` included,
    where W is the 1/8 image width and not the number of disparity bins."""
    _, H8, W8, _ = disp_low.shape
    dmin = disp_low - lower_bound
    dmax = disp_low + upper_bound
    x = torch.arange(W8, dtype=gt.dtype, device=gt.device)[None, None, :, None]
    invalid = ((lower_bound < 0).to(gt.dtype)
               + (upper_bound >= W8 - 1).to(gt.dtype)
               + (upper_bound > x).to(gt.dtype))
    valid = 1.0 - invalid.clamp(max=1.0)
    gt8 = resize_bilinear(gt, (H8, W8), align_corners=False) / 8.0

    low_out = ((dmin - gt8) > 0).to(gt.dtype) * valid
    low_in = valid - low_out
    up_out = ((gt8 - dmax) > 0).to(gt.dtype) * valid
    up_in = valid - up_out
    denom = global_sum(valid.sum(), group) + 1e-8
    lower_range = ((gt8 - dmin).abs()
                   * (low_out * gamma + low_in * (1 - gamma))).sum() / denom
    upper_range = ((gt8 - dmax).abs()
                   * (up_out * gamma + up_in * (1 - gamma))).sum() / denom
    return ((lower_range + upper_range) * 4.0
            + multi_equal_loss(preds, gt, weights, group))
