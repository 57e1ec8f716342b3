"""Building blocks (NCHW modules).

Counterparts of ``stereoformer_tpu/nn/blocks.py`` (``FusedConv``,
``ConvLReLU``, ``ConvBnRelu``, ``ResBlock``, ``FPNFusion``). Submodule names
follow the reference ``state_dict`` keys. BatchNorm is ``norm.BatchNorm2d``,
Flax's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_conv import conv3x3_fused
from ..ops.resize import resize_bilinear
from .conv import Conv
from .norm import BatchNorm2d


# the TPU's routing ceiling: 3x3 sites with 64 <= C_in <= 96 take the
# fused conv (JAX FusedConv.auto_max_c)
FUSED_MAX_C = 96


class FusedConv(nn.Conv2d):
    """A 3x3 stride-1 conv padded by 1, with bias, that routes to the fused
    conv (``ops/fused_conv.py``) where the JAX package routes to its Pallas
    kernel: 64 <= C_in <= ``FUSED_MAX_C``. Other sites are a plain
    ``F.conv2d`` (cuDNN on the GPU), as JAX leaves them to XLA.

    ``forward(x, prologue=None, with_stats=False)``: x NCHW; at a routed
    site x must be ``channels_last`` (its NHWC view is what the kernel
    reads), and the output is ``channels_last`` too. ``prologue=(s, t)``
    [B, C] feeds relu(x*s + t) to the conv; with ``with_stats`` it returns
    (y, (S1, S2)), the output's per-sample channel sums [B, Co], or
    (y, None) at a site that is not routed."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self.routed = 64 <= in_channels <= FUSED_MAX_C

    def forward(self, x, prologue=None, with_stats=False):
        s, t = prologue or (None, None)
        if not self.routed:
            if s is not None:
                x = torch.relu(x * s[:, :, None, None] + t[:, :, None, None])
            y = super().forward(x)
            return (y, None) if with_stats else y
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("FusedConv: a routed site takes channels_last x")
        w = self.weight.permute(2, 3, 1, 0).contiguous()
        out = conv3x3_fused(x.permute(0, 2, 3, 1), w, self.bias, s=s, t=t,
                            with_stats=with_stats)
        if with_stats:
            y, s1, s2 = out
            return y.permute(0, 3, 1, 2), (s1, s2)
        return out.permute(0, 3, 1, 2)


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
        self.bn = BatchNorm2d(out_channels)

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
        self.bn1 = BatchNorm2d(out_channels)
        self.conv2 = Conv(out_channels, out_channels, 3)
        self.bn2 = BatchNorm2d(out_channels)
        self.shortcut = None
        if stride != 1 or in_channels != out_channels:
            self.shortcut = nn.Sequential(
                Conv(in_channels, out_channels, 1, stride),
                BatchNorm2d(out_channels))

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
