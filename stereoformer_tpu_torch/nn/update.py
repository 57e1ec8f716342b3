"""The GRU refinement step of LowCNN_gru.

Counterparts of ``stereoformer_tpu/nn/update.py`` (``GuidanceEncoder``,
``OffsetHead``, ``GRUUpdate``). Disparities, volumes, images and the mask
keep the JAX package's NHWC layouts; the convolutions and the hidden state
are NCHW. Submodule names follow the reference ``state_dict`` keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (
    disp_warp,
    local_soft_argmin,
    make_candidates,
    uncertainty_volume,
)
from .conv import Conv
from .norm import BatchNorm2d
from .gru import ConvGRU


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv_bn_relu(in_channels, out_channels):
    return nn.Sequential(Conv(in_channels, out_channels, 3, bias=False),
                         BatchNorm2d(out_channels), nn.ReLU())


class GuidanceEncoder(nn.Module):
    """Encodes the photometric error map (right image warped by the current
    disparity, minus left) and the uncertainty volume into 2*hidden
    channels, concatenated [error, uncertainty]."""

    def __init__(self, num_bins: int, hidden: int = 32):
        super().__init__()
        self.disparity_error_encoder = _conv_bn_relu(3, hidden)
        self.uncertain_encoder = _conv_bn_relu(num_bins, hidden)

    def forward(self, cur_disp, left, right, prob):
        """cur_disp [B, H, W, 1]; left, right [B, H, W, 3] at the
        disparity's resolution; prob [B, H, W, D] -> [B, 2*hidden, H, W]."""
        warped_left, _ = disp_warp(right, cur_disp)
        error_map = warped_left - left
        uncert = uncertainty_volume(prob, cur_disp)
        return torch.cat([self.disparity_error_encoder(_nchw(error_map)),
                          self.uncertain_encoder(_nchw(uncert))], dim=1)


class OffsetHead(nn.Module):
    """conv-ReLU-conv-ReLU -> 2 non-negative range offsets."""

    def __init__(self, input_dim: int, hidden: int = 64):
        super().__init__()
        self.conv1 = Conv(input_dim, hidden, 3)
        self.conv2 = Conv(hidden, 2, 3)

    def forward(self, x):
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class GRUUpdate(nn.Module):
    """One refinement step: guidance -> ConvGRU -> bounds and convex-upsample
    mask -> candidates -> local soft-argmin over the volume."""

    def __init__(self, num_bins: int, hidden: int = 32, num_samples: int = 20):
        super().__init__()
        gru_dim = 2 * hidden
        self.num_samples = num_samples
        self.encoder = GuidanceEncoder(num_bins, hidden)
        self.gru = ConvGRU(gru_dim, gru_dim)
        self.offset = OffsetHead(gru_dim)
        self.mask = nn.Sequential(Conv(gru_dim, 256, 3), nn.ReLU(),
                                  Conv(256, 64 * 9, 1))

    def forward(self, volume, cur_disp, left, right, hidden, prob):
        """volume, prob [B, H, W, D]; cur_disp [B, H, W, 1]; left, right
        [B, H, W, 3]; hidden [B, 2*hidden, H, W] or None.

        Returns (disp [B, H, W, 1], hidden, mask [B, H, W, 576])."""
        feats = self.encoder(cur_disp, left, right, prob)
        hidden = self.gru(feats, hidden)
        mask = 0.25 * _nhwc(self.mask(hidden))
        bounds = _nhwc(self.offset(hidden))
        lower = cur_disp - bounds[..., 0:1]
        upper = cur_disp + bounds[..., 1:2]
        cands = make_candidates(lower, upper, cur_disp, self.num_samples,
                                volume.shape[-1])
        disp = local_soft_argmin(volume, cands.contiguous())
        return disp, hidden, mask
