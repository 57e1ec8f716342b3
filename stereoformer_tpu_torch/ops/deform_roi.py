"""Deformable position-sensitive RoI pooling (NHWC), DCNv2's third op.

Counterpart of ``stereoformer_tpu/ops/deform_roi.py::deform_psroi_pool``:
each RoI is pooled into a P x P grid of bins; a bin's window is shifted by
its (dx, dy) offset times ``trans_std`` and the RoI's size, and its value is
the mean of ``sample_per_part``^2 bilinear samples (``ops.deform``'s
``bilinear_sample_2d``), samples outside the image left out of the count.
The RoI corners are rounded and scaled as the CUDA kernel's, the end
corner one pixel on (+1, then -0.5). All RoIs and bins are one batched
gather; the gradient is autograd's, as the JAX op's is autodiff's. No
model calls it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .deform import bilinear_sample_2d


def deform_psroi_pool(features: torch.Tensor, rois: torch.Tensor,
                      offsets: Optional[torch.Tensor], pooled_size: int = 7,
                      spatial_scale: float = 1.0, trans_std: float = 0.1,
                      sample_per_part: int = 4) -> torch.Tensor:
    """features [B, H, W, C]; rois [N, 5] as (batch index, x1, y1, x2, y2)
    in image coordinates; offsets [N, P, P, 2] (dx, dy a bin) or None
    (plain PS-RoI pooling). -> [N, P, P, C]."""
    B, H, W, C = features.shape
    N = rois.shape[0]
    P, S = pooled_size, sample_per_part
    dt, dev = features.dtype, features.device
    batch_idx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=0.1)
    roi_h = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = roi_w / P, roi_h / P
    if offsets is None:
        offsets = features.new_zeros((N, P, P, 2))
    off_x = offsets[..., 0] * trans_std * roi_w[:, None, None]
    off_y = offsets[..., 1] * trans_std * roi_h[:, None, None]

    p = torch.arange(P, dtype=dt, device=dev)
    i = (torch.arange(S, dtype=dt, device=dev) + 0.5) / S
    # sample coordinates [N, P (h), P (w), S (y), S (x)]
    ys = (y1[:, None, None, None, None]
          + (p[None, :, None, None, None] + i[None, None, None, :, None])
          * bin_h[:, None, None, None, None]
          + off_y[:, :, :, None, None])
    xs = (x1[:, None, None, None, None]
          + (p[None, None, :, None, None] + i[None, None, None, None, :])
          * bin_w[:, None, None, None, None]
          + off_x[:, :, :, None, None])
    full = (N, P, P, S, S)
    ys, xs = ys.expand(full), xs.expand(full)
    inside = ((ys >= -0.5) & (ys <= H - 0.5) & (xs >= -0.5)
              & (xs <= W - 0.5)).to(dt)
    vals = bilinear_sample_2d(features[batch_idx], ys.reshape(N, -1),
                              xs.reshape(N, -1)).reshape(N, P, P, S, S, C)
    vals = vals * inside[..., None]
    count = inside.sum((3, 4))
    return vals.sum((3, 4)) / torch.clamp(count, min=1.0)[..., None]
