"""Deformable-conv and deformable-RoI modules (NCHW), DCN's module surface.

Counterparts of ``stereoformer_tpu/nn/deform.py``: ``ModulatedDeformConv``
(DCNv2, offsets and mask given), ``ModulatedDeformNormal`` (offsets and mask
from a second feature map), ``DeformConvV1`` (v1: offsets given, no mask),
``DeformConvV1Pack`` (offsets from a conv of the input), ``DeformRoIPooling``
and ``DeformRoIPoolingPack`` (offsets and mask from a 3-layer FC head). No
model calls them.

Every conv is the exact gather form ``ops.modulated_deform_conv`` (any
stride and dilation, unbounded offsets), in float32 whatever ``dtype``,
which is the output's; the gradients are autograd's, as the JAX modules'
are autodiff's. Layouts are the reference DCN modules': x and outputs
NCHW, offsets [B, 2K, Ho, Wo] with channels 2t, 2t+1 the (dy, dx) of tap
t, the mask [B, K, Ho, Wo] (after the sigmoid), conv weights [Co, C, k, k];
the RoI modules take features [B, C, H, W], rois [N, 5] (batch index, x1,
y1, x2, y2) and offsets [N, 2, P, P] (dx, dy), and return [N, C, P, P].
Parameter names are the reference's (``weight``, ``bias``,
``conv_offset_mask``, ``conv_offset``, ``offset_mask_fc.{0,2,4}``);
``weights.module_state_dict_from_jax(module, variables)`` carries the JAX
modules' across.
Weights start he-normal over the fan-in, biases and every offset (and
mask) predictor at zero, as in JAX. ``DeformRoIPoolingPack``'s first FC
layer reads the pooled RoI flattened as (P, P, C), the JAX module's order.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.deform import modulated_deform_conv
from ..ops.deform_roi import deform_psroi_pool
from .conv import check_dtype


def _he_normal_(weight: torch.Tensor) -> None:
    fan_in = weight[0].numel()
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_in))


class ModulatedDeformConv(nn.Module):
    """DCNv2 with the offsets and the mask given: ``forward(x, offset,
    mask)``, x [B, C, H, W], offset [B, 2K, Ho, Wo], mask [B, K, Ho, Wo] or
    None (v1) -> [B, Co, Ho, Wo]."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, bias: bool = True, dtype=None):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.dilation = padding, dilation
        self.out_dtype = check_dtype(dtype)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        _he_normal_(self.weight)
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)

    def _deform(self, x, offset, mask):
        """The gather form on NCHW x with NHWC offsets [B, Ho, Wo, K, 2]
        and mask [B, Ho, Wo, K] (or None)."""
        w = self.weight.permute(2, 3, 1, 0).reshape(-1, self.weight.shape[0])
        out = modulated_deform_conv(
            x.float().permute(0, 2, 3, 1), offset, mask, w, self.bias,
            kernel_size=self.kernel_size, stride=self.stride,
            padding=self.padding, dilation=self.dilation).permute(0, 3, 1, 2)
        return out if self.out_dtype is None else out.to(self.out_dtype)

    def forward(self, x, offset, mask=None):
        B, _, Ho, Wo = offset.shape
        off = offset.float().permute(0, 2, 3, 1).reshape(B, Ho, Wo, -1, 2)
        m = None if mask is None else mask.float().permute(0, 2, 3, 1)
        return self._deform(x, off, m)


def _offset_conv(in_channels: int, out_channels: int, k: int, stride: int,
                 padding: int) -> nn.Conv2d:
    """A k x k conv that starts at zero, as the JAX modules' offset
    predictors."""
    conv = nn.Conv2d(in_channels, out_channels, k, stride=stride,
                     padding=padding)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


def _offsets_mask(om: torch.Tensor, K: int):
    """A 3K-channel prediction [B, 3K, Ho, Wo] -> offsets [B, Ho, Wo, K, 2]
    (channels 2t, 2t+1) and the sigmoid of the last K as the mask."""
    om = om.permute(0, 2, 3, 1)
    offsets = om[..., :2 * K].reshape(*om.shape[:3], K, 2)
    return offsets, torch.sigmoid(om[..., 2 * K:])


class ModulatedDeformNormal(ModulatedDeformConv):
    """DCNv2 whose offsets and mask come from a second feature map:
    ``forward(input_feature, normal_feature)``; ``conv_offset_mask`` (zero at
    init; the JAX module's ``offset_mask``) reads ``normal_feature``
    (``normal_channels`` channels, ``in_channels`` by default), the
    sampling and the weight apply to ``input_feature``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, bias: bool = True,
                 normal_channels: int | None = None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, bias, dtype)
        self.conv_offset_mask = _offset_conv(
            normal_channels or in_channels, 3 * kernel_size ** 2, kernel_size,
            stride, padding)

    def forward(self, input_feature, normal_feature):
        om = self.conv_offset_mask(normal_feature.float())
        return self._deform(input_feature,
                            *_offsets_mask(om, self.kernel_size ** 2))


class DeformConvV1(ModulatedDeformConv):
    """The v1 deformable conv: ``forward(x, offset)``, no mask."""

    def forward(self, x, offset):
        return super().forward(x, offset, None)


class DeformConvV1Pack(DeformConvV1):
    """v1 "Pack": the offsets from ``conv_offset``, a conv of the input to
    2K channels that starts at zero (a plain conv at init). Its weight and
    bias are the JAX module's ``deform`` submodule's."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, bias: bool = True, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, bias, dtype)
        self.conv_offset = _offset_conv(in_channels, 2 * kernel_size ** 2,
                                        kernel_size, stride, padding)

    def forward(self, x):
        return super().forward(x, self.conv_offset(x.float()))


class DeformRoIPooling(nn.Module):
    """Deformable PS-RoI pooling (``ops.deform_roi.deform_psroi_pool``):
    ``forward(features, rois, offsets=None)``, offsets ignored with
    ``no_trans``."""

    def __init__(self, pooled_size: int = 7, spatial_scale: float = 1.0,
                 trans_std: float = 0.0, sample_per_part: int = 4,
                 no_trans: bool = False):
        super().__init__()
        self.pooled_size, self.spatial_scale = pooled_size, spatial_scale
        self.trans_std, self.sample_per_part = trans_std, sample_per_part
        self.no_trans = no_trans

    def pool(self, features, rois, offsets=None):
        """NCHW features, NHWC offsets [N, P, P, 2] -> [N, P, P, C]."""
        return deform_psroi_pool(
            features.permute(0, 2, 3, 1), rois, offsets,
            pooled_size=self.pooled_size, spatial_scale=self.spatial_scale,
            trans_std=self.trans_std, sample_per_part=self.sample_per_part)

    def forward(self, features, rois, offsets=None):
        if self.no_trans or offsets is None:
            offsets = None
        else:
            offsets = offsets.permute(0, 2, 3, 1)
        return self.pool(features, rois, offsets).permute(0, 3, 1, 2)


class DeformRoIPoolingPack(DeformRoIPooling):
    """Deformable PS-RoI pooling "Pack" of ``in_channels`` features: the RoI
    pooled without offsets, a 3-layer FC head (``offset_mask_fc``, ReLUs
    between, its last layer zero at init) gives each bin (dx, dy) and a
    mask logit, the RoI is pooled again with the offsets and scaled by the
    sigmoid of the mask. With ``no_trans`` it is plain pooling."""

    def __init__(self, in_channels: int, pooled_size: int = 7,
                 spatial_scale: float = 1.0, trans_std: float = 0.0,
                 sample_per_part: int = 4, no_trans: bool = False,
                 deform_fc_dim: int = 1024):
        super().__init__(pooled_size, spatial_scale, trans_std,
                         sample_per_part, no_trans)
        P = pooled_size
        self.offset_mask_fc = nn.Sequential(
            nn.Linear(P * P * in_channels, deform_fc_dim), nn.ReLU(),
            nn.Linear(deform_fc_dim, deform_fc_dim), nn.ReLU(),
            nn.Linear(deform_fc_dim, P * P * 3))
        for layer in self.offset_mask_fc[:4:2]:
            _he_normal_(layer.weight)
            nn.init.zeros_(layer.bias)
        nn.init.zeros_(self.offset_mask_fc[4].weight)
        nn.init.zeros_(self.offset_mask_fc[4].bias)

    def forward(self, features, rois):
        roi = self.pool(features, rois)
        if self.no_trans:
            return roi.permute(0, 3, 1, 2)
        N, P = rois.shape[0], self.pooled_size
        om = self.offset_mask_fc(roi.reshape(N, -1)).reshape(N, 3, P, P)
        offsets = torch.stack([om[:, 0], om[:, 1]], dim=-1)
        mask = torch.sigmoid(om[:, 2])[..., None]
        return (self.pool(features, rois, offsets) * mask).permute(0, 3, 1, 2)
