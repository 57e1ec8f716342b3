"""Disparity warping (NHWC).

Counterpart of ``stereoformer_tpu/ops/warp.py`` (``disp_warp``,
``lr_warp_error``): the right image is sampled at exactly x - disp along
W, with the border clamp of the JAX package's gather sampler.
``F.grid_sample`` is not used: with the reference's coordinate
normalisation it samples half a pixel off (README deviation #2).
"""

from __future__ import annotations

import torch


def _sample_x_border(img: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear sample of img [B, H, W, C] along W at coordinates x [B, H, W],
    indices clamped to the image (border padding)."""
    W, C = img.shape[2], img.shape[3]
    x0 = torch.floor(x)
    t = (x - x0)[..., None]
    x0 = x0.long()
    i0 = x0.clamp(0, W - 1)[..., None].expand(-1, -1, -1, C)
    i1 = (x0 + 1).clamp(0, W - 1)[..., None].expand(-1, -1, -1, C)
    v0 = torch.gather(img, 2, i0)
    v1 = torch.gather(img, 2, i1)
    return v0 * (1 - t) + v1 * t


def disp_warp(img: torch.Tensor, disp: torch.Tensor):
    """Warp ``img`` (the right view, [B, H, W, C]) by the disparity ``disp``
    [B, H, W, 1]: out(x) = img(x - disp(x)).

    Returns (warped [B, H, W, C], valid [B, H, W, 1] in {0, 1}); valid is 1
    where the sample point lies inside the image, 0 <= x - disp <= W - 1."""
    W = img.shape[2]
    x = torch.arange(W, dtype=disp.dtype, device=disp.device)
    sx = x - disp[..., 0]
    warped = _sample_x_border(img, sx)
    valid = ((sx >= 0) & (sx <= W - 1)).to(img.dtype)[..., None]
    return warped, valid


def lr_warp_error(img_left: torch.Tensor, disp: torch.Tensor,
                  img_right: torch.Tensor) -> torch.Tensor:
    """img_right - warp(img_left, disp) at the disparity's resolution: an
    image wider than ``disp`` [B, H, W, 1] is first resized to it
    (bilinear, align_corners=False)."""
    from .resize import resize_bilinear

    H, W = disp.shape[1:3]
    if img_left.shape[2] > W:
        img_left = resize_bilinear(img_left, (H, W))
    if img_right.shape[2] > W:
        img_right = resize_bilinear(img_right, (H, W))
    return img_right - disp_warp(img_left, disp)[0]
