"""Spatial-attention residual disparity refiners.

Counterparts of ``stereoformer_tpu/nn/residual.py``: ``SAModule`` (a
sigmoid attention map) and ``ResSubmoduleAttention`` (pool the images to
the disparity's scale, warp the right one by it, weigh [feature, left,
right, error, disparity] by the attention map, an encoder-decoder with 1x1
skips, a residual of the disparity's scale). No model calls them. Their
interfaces are NHWC, as the refinement heads' are; inside they are NCHW
and float32, BatchNorm Flax's. ``deform=True`` makes the bottleneck conv a
``DeformConv`` (window 2, its offsets and mask from a zero-initialised
conv): the ``deform_sample`` kernel on the GPU. Keys are the port's own (no
reference checkpoint of these heads exists);
``weights.module_state_dict_from_jax(module, variables)`` carries the JAX
modules' across.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import disp_warp, resize_bilinear
from .blocks import DeformConv
from .conv import Conv, ConvTransposeSame
from .norm import BatchNorm2d


class SAModule(nn.Module):
    """conv1x1-BN-ReLU, conv3x3-BN-ReLU (``ndf`` channels), conv1x1 to
    ``out`` channels, sigmoid; no biases. Keys ``conv1``-``conv3``,
    ``bn1``, ``bn2``."""

    def __init__(self, in_channels: int, ndf: int = 16, out: int = 1):
        super().__init__()
        self.conv1 = Conv(in_channels, ndf, 1, bias=False)
        self.bn1 = BatchNorm2d(ndf)
        self.conv2 = Conv(ndf, ndf, 3, bias=False)
        self.bn2 = BatchNorm2d(ndf)
        self.conv3 = Conv(ndf, out, 1, bias=False)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        return torch.sigmoid(self.conv3(x))


def _cbr(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    """conv3x3 (no bias) + BatchNorm; the ReLU is the caller's."""
    return nn.Sequential(Conv(cin, cout, 3, stride, bias=False),
                         BatchNorm2d(cout))


def _up(cin: int, cout: int) -> nn.Sequential:
    """Flax's SAME stride-2 transposed conv (no bias) + BatchNorm."""
    return nn.Sequential(ConvTransposeSame(cin, cout), BatchNorm2d(cout))


class ResSubmoduleAttention(nn.Module):
    """Attention-gated residual refinement of a disparity at scale 1/2^s.

    ``forward(left, right, disp, feature)``: images [B, H, W, 3], disp
    [B, H/2^s, W/2^s, 1], feature [B, H/2^s, W/2^s, ``feature_channels``]
    (H/2^s and W/2^s multiples of 4) -> the residual [B, H/2^s, W/2^s, 1],
    already in the input's pixels (times the images' size over the
    disparity's, ``left.shape[1] // disp.shape[1]``, as the JAX head).

    The images are average-pooled by 2^``scale``, then resized to the
    disparity's size where that leaves them another (a size that is not a
    power of two), the right one warped by the scaled disparity; the
    attention map of [left, right, error, disparity] (10 channels) weighs
    [feature, left, right, error, disparity]; ``conv1``-``conv4``
    (``out_planes`` x 1, 2, 4, 4; stride 2 at 1 and 3), ``conv5`` and
    ``conv6`` the transposed convs, ``redir2``/``redir1`` the 1x1 skips,
    ``res`` the 1x1 output conv."""

    def __init__(self, scale: int, feature_channels: int,
                 out_planes: int = 64, deform: bool = False):
        super().__init__()
        f = out_planes
        self.scale, self.deform = scale, deform
        cin = feature_channels + 10
        self.attention = SAModule(10)
        self.conv1 = _cbr(cin, f, 2)
        self.conv2 = _cbr(f, 2 * f)
        self.conv3 = _cbr(2 * f, 4 * f, 2)
        self.conv4 = (nn.Sequential(DeformConv(4 * f, 4 * f),
                                    BatchNorm2d(4 * f)) if deform
                      else _cbr(4 * f, 4 * f))
        self.conv5 = _up(4 * f, 2 * f)
        self.conv6 = _up(2 * f, f)
        self.redir2 = Conv(2 * f, 2 * f, 1, bias=False)
        self.redir1 = Conv(cin, f, 1, bias=False)
        self.res = Conv(f, 1, 1, bias=False)

    def forward(self, left, right, disp, feature):
        factor = left.shape[1] // disp.shape[1]
        if self.scale:
            k = 2 ** self.scale
            left, right = (F.avg_pool2d(x.permute(0, 3, 1, 2), k, k)
                           .permute(0, 2, 3, 1) for x in (left, right))
        if left.shape[1] != disp.shape[1]:
            left = resize_bilinear(left, disp.shape[1:3])
            right = resize_bilinear(right, disp.shape[1:3])
        disp_s = disp / factor
        error = disp_warp(right, disp_s)[0] - left
        query = torch.cat([left, right, error, disp_s], dim=-1)
        query = query.permute(0, 3, 1, 2)
        gated = self.attention(query) * torch.cat(
            [feature.permute(0, 3, 1, 2), query], dim=1)
        c2 = torch.relu(self.conv2(torch.relu(self.conv1(gated))))
        c4 = torch.relu(self.conv4(torch.relu(self.conv3(c2))))
        c5 = torch.relu(self.conv5(c4) + self.redir2(c2))
        c6 = torch.relu(self.conv6(c5) + self.redir1(gated))
        return self.res(c6).permute(0, 2, 3, 1) * factor
