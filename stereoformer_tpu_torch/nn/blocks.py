"""Building blocks (NCHW modules).

Counterparts of ``stereoformer_tpu/nn/blocks.py`` (``FusedConv``,
``ConvLReLU``, ``ConvBnRelu``, ``ResBlock``, ``DeformConv``, ``DeformBlock``,
``FPNFusion``). Submodule names follow the reference ``state_dict`` keys.
BatchNorm is ``norm.BatchNorm2d``, Flax's.

``dtype`` is the JAX modules' compute dtype (``nn/conv.py``): None computes
in float32, ``torch.bfloat16`` casts each conv's input and kernel and
rounds where the JAX module rounds; BatchNorm computes in float32 and casts
its output. ``DeformConv`` samples and multiplies in float32 whatever
``dtype`` (its kernel ``deform_sample`` is float32) and casts only its
output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform import deform_conv_fused, modulated_deform_conv
from ..ops.fused_conv import KERNEL_CO, conv3x3_fused
from ..ops.resize import resize_bilinear
from . import bf16
from .conv import Conv, Conv2d, check_dtype
from .norm import BatchNorm2d


# the TPU's default routing ceiling: 3x3 sites with 64 <= C_in <= 96 take
# the fused conv (JAX FusedConv.auto_max_c)
FUSED_MAX_C = 96
# FusedConv's routes (JAX FusedConv.impl)
IMPLS = ("auto", "pallas", "xla")


def kernel_routes(in_channels: int, out_channels: int, impl: str = "auto",
                  auto_max_c: int = FUSED_MAX_C) -> bool:
    """Whether a ``FusedConv`` of these widths takes the fused conv where
    JAX's takes its Pallas kernel: ``impl="auto"`` 64 <= C_in <=
    ``auto_max_c``, ``"pallas"`` every width, ``"xla"`` none; and only
    where the kernels can run and train it: C_in and Co both in
    ``KERNEL_CO``, since the forward has Co outputs, its dx conv C_in and
    its weight gradient ``conv2d_dw`` Co from C_in inputs."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "xla" or (impl == "auto"
                         and not 64 <= in_channels <= auto_max_c):
        return False
    return in_channels in KERNEL_CO and out_channels in KERNEL_CO


def prologue_fma(x, s, t):
    """relu(x * s + t) for NCHW x and [B, C] s, t, x*s + t rounded once to
    float32, as XLA's FMA gives it (the product of a bf16 or float32 x and
    a float32 s is exact in float64)."""
    u = (x.double() * s[:, :, None, None].double()
         + t[:, :, None, None].double())
    return torch.relu(u.float())


class FusedConv(Conv2d):
    """A 3x3 stride-1 conv padded by 1, with bias, that routes to the fused
    conv (``ops/fused_conv.py``) where the JAX package routes to its Pallas
    kernel and the kernels have its widths (``kernel_routes``): with
    ``impl="auto"`` (the default) 64 <= C_in <= ``auto_max_c`` (96 by
    default), with ``impl="pallas"`` at any width, with ``impl="xla"``
    nowhere. Other sites are a plain ``F.conv2d`` (cuDNN on the GPU), as
    JAX leaves them to XLA. ``impl="pallas"`` at widths the kernels lack
    (C_in or Co not in ``KERNEL_CO``) raises ``ValueError``.

    ``forward(x, prologue=None, with_stats=False)``: x NCHW; at a routed
    site x must be ``channels_last`` (its NHWC view is what the kernel
    reads), and the output is ``channels_last`` too. ``prologue=(s, t)``
    [B, C] feeds relu(x*s + t) to the conv; with ``with_stats`` it returns
    (y, (S1, S2)), the output's per-sample channel sums [B, Co], or
    (y, None) at a site that is not routed. At a routed site the gradients
    of x, s, t, the weight and the bias come from the fused conv's own
    backward (``ops/fused_conv.py::fused_conv_backward``).

    ``dtype=torch.bfloat16``: x, the weight and the bias are cast to bf16
    and the output is bf16; s and t stay float32 and relu(x*s + t) is
    rounded to bf16 before the conv (JAX ``FusedConv``). A routed site
    takes the fused conv's bf16 form (float32 sums, one rounding); a site
    that is not routed is the JAX XLA route, ``Conv2d``'s two roundings."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None,
                 impl: str = "auto", auto_max_c: int = FUSED_MAX_C):
        super().__init__(in_channels, out_channels, 3, padding=1,
                         dtype=dtype)
        self.routed = kernel_routes(in_channels, out_channels, impl,
                                    auto_max_c)
        if impl == "pallas" and not self.routed:
            raise ValueError(
                f"FusedConv(impl='pallas'): the fused conv and its dx conv "
                f"take C_in and Co in {KERNEL_CO}, got {in_channels} -> "
                f"{out_channels}")

    def forward(self, x, prologue=None, with_stats=False):
        s, t = prologue or (None, None)
        dt = self.compute_dtype
        if not self.routed:
            if s is not None and dt is None:
                x = torch.relu(x * s[:, :, None, None] + t[:, :, None, None])
            elif s is not None:
                x = prologue_fma(x, s, t).to(dt)
            y = super().forward(x)
            return (y, None) if with_stats else y
        # torch.export's trace of a CUDA model (torch 2.11) gives a cuDNN
        # conv of a channels_last input a contiguous output where the card
        # gives channels_last: while exporting, the layout is checked where
        # the kernel launches (kernels.check_inputs) instead
        if (not x.is_contiguous(memory_format=torch.channels_last)
                and not torch.compiler.is_exporting()):
            raise ValueError("FusedConv: a routed site takes channels_last x")
        w, b = self.weight, self.bias
        if dt is not None:
            x, w, b = x.to(dt), w.to(dt), b.to(dt)
        out = conv3x3_fused(x.permute(0, 2, 3, 1),
                            w.permute(2, 3, 1, 0).contiguous(), b, s=s, t=t,
                            with_stats=with_stats)
        if with_stats:
            y, s1, s2 = out
            return y.permute(0, 3, 1, 2), (s1, s2)
        return out.permute(0, 3, 1, 2)


class LeakyReLU(nn.Module):
    """LeakyReLU(0.1) with JAX's bf16 slope (``nn/bf16.py``)."""

    def forward(self, x):
        return bf16.leaky_relu(x, 0.1)


class ConvLReLU(nn.Sequential):
    """conv + LeakyReLU(0.1); keys ``0.weight``, ``0.bias``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dtype=None):
        super().__init__(Conv(in_channels, out_channels, kernel_size, stride,
                              dtype=dtype),
                         LeakyReLU())


class ConvBnRelu(nn.Module):
    """conv (no bias) + BatchNorm + ReLU; keys ``conv``, ``bn``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dtype=None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride,
                         bias=False, dtype=dtype)
        self.bn = BatchNorm2d(out_channels, dtype=dtype)

    def forward(self, x):
        return F.relu(self.bn(self.conv.forward_f32(x)))


class ResBlock(nn.Module):
    """conv-BN-ReLU + conv-BN, plus a 1x1 conv-BN shortcut when the shape
    changes, then ReLU of the sum; keys ``conv1``, ``bn1``, ``conv2``,
    ``bn2``, ``shortcut.0``, ``shortcut.1``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dtype=None):
        super().__init__()
        self.conv1 = Conv(in_channels, out_channels, kernel_size, stride,
                          dtype=dtype)
        self.bn1 = BatchNorm2d(out_channels, dtype=dtype)
        self.conv2 = Conv(out_channels, out_channels, 3, dtype=dtype)
        self.bn2 = BatchNorm2d(out_channels, dtype=dtype)
        self.shortcut = None
        if stride != 1 or in_channels != out_channels:
            self.shortcut = nn.Sequential(
                Conv(in_channels, out_channels, 1, stride, dtype=dtype),
                BatchNorm2d(out_channels, dtype=dtype))

    def forward(self, x):
        # each conv's bias add feeds a BatchNorm, which reads it in float32
        residual = x
        if self.shortcut is not None:
            residual = self.shortcut[1](self.shortcut[0].forward_f32(x))
        out = F.relu(self.bn1(self.conv1.forward_f32(x)))
        out = self.bn2(self.conv2.forward_f32(out))
        return F.relu(out + residual)


class DeformConv(nn.Module):
    """Modulated deformable conv "Pack" (DCNv2): ``conv_offset_mask``, a
    k x k conv of the input to 3K channels (zero at init), gives per tap the
    offsets (dy, dx) (channels 2t, 2t+1 of the first 2K) and the mask
    (sigmoid of the last K); then the deformable conv with ``weight``
    [Co, C, k, k] and ``bias`` [Co], the reference's DCNv2 Pack names.

    ``window`` (stride 1 only): offsets clamped to +-window px, through
    ``ops.deform_conv_fused``, the kernel on the GPU. ``window=None``: the
    exact gather form ``ops.modulated_deform_conv``, any stride. x and the
    output are NCHW. Everything is float32; ``dtype`` is the output's."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, window: int | None = 2, dtype=None):
        super().__init__()
        self.out_dtype = check_dtype(dtype)
        if window is not None and stride != 1:
            raise ValueError(
                "DeformConv: window-clamped form supports stride=1 only; "
                "pass window=None for strided deformable convs (exact "
                "unbounded gather semantics).")
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.dilation, self.window = padding, dilation, window
        K = kernel_size * kernel_size
        self.conv_offset_mask = nn.Conv2d(in_channels, 3 * K, kernel_size,
                                          stride=stride, padding=padding)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))
        # the JAX module's init: he-normal over the fan-in, zero bias, the
        # offset conv zero (a plain conv modulated by 0.5)
        nn.init.kaiming_normal_(self.weight, nonlinearity="relu")
        for p in (self.bias, self.conv_offset_mask.weight,
                  self.conv_offset_mask.bias):
            nn.init.zeros_(p)

    def forward(self, x):
        K = self.kernel_size * self.kernel_size
        x = x.float()
        om = self.conv_offset_mask(x).permute(0, 2, 3, 1)   # NHWC, 3K
        offsets = om[..., :2 * K].reshape(*om.shape[:3], K, 2).contiguous()
        mask = torch.sigmoid(om[..., 2 * K:]).contiguous()
        xh = x.permute(0, 2, 3, 1).contiguous()
        # [Co, C, k, k] -> [K*C, Co], tap-major (ky, kx, cin)
        weight = self.weight.permute(2, 3, 1, 0).reshape(
            -1, self.weight.shape[0])
        if self.window is None:
            out = modulated_deform_conv(
                xh, offsets, mask, weight, kernel_size=self.kernel_size,
                stride=self.stride, padding=self.padding,
                dilation=self.dilation)
        else:
            out = deform_conv_fused(xh, offsets, mask, weight,
                                    self.kernel_size, self.padding,
                                    self.dilation, self.window)
        out = (out + self.bias).permute(0, 3, 1, 2)
        return out if self.out_dtype is None else out.to(self.out_dtype)


class DeformBlock(nn.Module):
    """ResBlock whose second conv is a ``DeformConv``, at stride 1:
    conv3x3-BN-ReLU, DeformConv-BN, plus a 1x1 conv-BN shortcut when the
    width changes, then ReLU of the sum; keys as ``ResBlock``'s (``conv2``
    is the DeformConv)."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__()
        self.conv1 = Conv(in_channels, out_channels, 3, dtype=dtype)
        self.bn1 = BatchNorm2d(out_channels, dtype=dtype)
        self.conv2 = DeformConv(out_channels, out_channels, dtype=dtype)
        self.bn2 = BatchNorm2d(out_channels, dtype=dtype)
        self.shortcut = None
        if in_channels != out_channels:
            self.shortcut = nn.Sequential(
                Conv(in_channels, out_channels, 1, dtype=dtype),
                BatchNorm2d(out_channels, dtype=dtype))

    def forward(self, x):
        residual = x
        if self.shortcut is not None:
            residual = self.shortcut[1](self.shortcut[0].forward_f32(x))
        out = F.relu(self.bn1(self.conv1.forward_f32(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class FPNFusion(nn.Module):
    """Top-down fusion over [1/32, 1/16, 1/8] features: bilinear resize to
    the skip's size (align_corners=True), concat [up, skip], conv-BN-ReLU;
    keys ``layer_list.{i}``."""

    def __init__(self, channels=(512, 512, 256), dtype=None):
        super().__init__()
        self.layer_list = nn.ModuleList(
            ConvBnRelu(channels[i] + channels[i + 1], channels[i + 1],
                       dtype=dtype)
            for i in range(len(channels) - 1))

    def forward(self, features):
        out = features[0]
        for skip, layer in zip(features[1:], self.layer_list):
            up = resize_bilinear(out.permute(0, 2, 3, 1), skip.shape[2:],
                                 align_corners=True).permute(0, 3, 1, 2)
            out = layer(torch.cat([up, skip.to(up.dtype)], dim=1))
        return out
