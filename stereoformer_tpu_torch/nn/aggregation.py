"""3-D cost-volume aggregation (PSMNet-style) and multi-scale volumes.

Counterparts of ``stereoformer_tpu/nn/aggregation.py``: ``ConvBn3D``,
``Hourglass3D`` and ``cost_volume_pyramid``. The modules take volumes
[B, C, D, H, W] (the JAX modules' [B, D, H, W, C] with the channels
first), in float32; BatchNorm is Flax's (``nn.norm.BatchNorm2d``, over every
axis but the channels). The
transposed convs are Flax's SAME ones (``nn.conv.ConvTransposeSame``). No
model calls them. ``cost_volume_pyramid`` keeps the ops' NHWC layouts.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import concat_volume, correlation_volume, difference_volume
from .conv import ConvTransposeSame
from .norm import BatchNorm2d


class ConvBn3D(nn.Module):
    """3-D conv (no bias, padding k // 2) + BatchNorm (+ ReLU); keys
    ``conv``, ``bn``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.conv = nn.Conv3d(in_channels, features, kernel_size,
                              stride=stride, padding=kernel_size // 2,
                              bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.relu else x


class Hourglass3D(nn.Module):
    """3-D encoder-decoder over a ``features``-channel volume: two stride-2
    stages of two ConvBn3D each (2 ``features`` channels; ``conv1``-
    ``conv4``), then two SAME transposed convs with BatchNorm (``conv5``,
    ``conv6``, each ``0`` the conv and ``1`` the norm), the first added to
    ``conv2``'s output, the second to the input, each sum ReLU'd."""

    def __init__(self, features: int):
        super().__init__()
        f2 = 2 * features
        self.conv1 = ConvBn3D(features, f2, stride=2)
        self.conv2 = ConvBn3D(f2, f2)
        self.conv3 = ConvBn3D(f2, f2, stride=2)
        self.conv4 = ConvBn3D(f2, f2)
        self.conv5 = nn.Sequential(ConvTransposeSame(f2, f2, dims=3),
                                   BatchNorm2d(f2))
        self.conv6 = nn.Sequential(ConvTransposeSame(f2, features, dims=3),
                                   BatchNorm2d(features))

    def forward(self, x):
        down1b = self.conv2(self.conv1(x))
        down2b = self.conv4(self.conv3(down1b))
        up1 = torch.relu(self.conv5(down2b) + down1b)
        return torch.relu(self.conv6(up1) + x)


def cost_volume_pyramid(left_feats, right_feats, max_disp: int,
                        mode: str = "correlation") -> list:
    """Full-range volumes of NHWC feature pairs, finest first: scale i
    takes max(max_disp // 2^i, 1) bins; ``mode`` "correlation" ([B, H, W,
    D], the ``corr_band`` kernel on the GPU), "concat" ([B, H, W, D, 2C]) or
    "difference" ([B, H, W, D, C])."""
    build = {"correlation": correlation_volume, "concat": concat_volume,
             "difference": difference_volume}
    if mode not in build:
        raise ValueError(mode)
    return [build[mode](lf, rf, max(max_disp // (2 ** i), 1))
            for i, (lf, rf) in enumerate(zip(left_feats, right_feats))]
