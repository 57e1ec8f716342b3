"""Building blocks of the LowCNN backbone (NCHW modules).

Counterparts of ``stereoformer_tpu/nn/blocks.py`` (``ConvLReLU``,
``ConvBnRelu``, ``ResBlock``, ``FPNFusion``). Submodule names follow the
reference ``state_dict`` keys. BatchNorm uses eps 1e-5, as Flax does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .conv import Conv


class ConvLReLU(nn.Sequential):
    """conv + LeakyReLU(0.1); keys ``0.weight``, ``0.bias``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1):
        super().__init__(Conv(in_channels, out_channels, kernel_size, stride),
                         nn.LeakyReLU(0.1))


class ConvBnRelu(nn.Module):
    """conv (no bias) + BatchNorm + ReLU; keys ``conv``, ``bn``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride,
                         bias=False)
        self.bn = nn.BatchNorm2d(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ResBlock(nn.Module):
    """conv-BN-ReLU + conv-BN, plus a 1x1 conv-BN shortcut when the shape
    changes, then ReLU of the sum; keys ``conv1``, ``bn1``, ``conv2``,
    ``bn2``, ``shortcut.0``, ``shortcut.1``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_channels, out_channels, kernel_size, stride)
        self.bn1 = nn.BatchNorm2d(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3)
        self.bn2 = nn.BatchNorm2d(out_channels)
        self.shortcut = None
        if stride != 1 or in_channels != out_channels:
            self.shortcut = nn.Sequential(
                Conv(in_channels, out_channels, 1, stride),
                nn.BatchNorm2d(out_channels))

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class FPNFusion(nn.Module):
    """Top-down fusion over [1/32, 1/16, 1/8] features: bilinear resize to
    the skip's size (align_corners=True), concat [up, skip], conv-BN-ReLU;
    keys ``layer_list.{i}``."""

    def __init__(self, channels=(512, 512, 256)):
        super().__init__()
        self.layer_list = nn.ModuleList(
            ConvBnRelu(channels[i] + channels[i + 1], channels[i + 1])
            for i in range(len(channels) - 1))

    def forward(self, features):
        out = features[0]
        for skip, layer in zip(features[1:], self.layer_list):
            up = resize_bilinear(out.permute(0, 2, 3, 1), skip.shape[2:],
                                 align_corners=True).permute(0, 3, 1, 2)
            out = layer(torch.cat([up, skip], dim=1))
        return out
