"""The refinement heads of LowCNN: the GRU step of LowCNN_gru (and its v2
of LowCNN_gru2) and the learned bounds of LowCNN_dynamic and
LowCNN_dynamic_supervised.

Counterparts of ``stereoformer_tpu/nn/update.py`` (``_images_at``,
``GuidanceEncoder``, ``OffsetHead``, ``GRUUpdate``, ``SmallUNet``,
``LearnedBounds``). Disparities, volumes, images and the mask keep the JAX
package's NHWC layouts; the convolutions and the hidden state are NCHW.
Submodule names follow the reference ``state_dict`` keys where they are
known (the GRU step's).

``dtype=torch.bfloat16`` (the GRU step only, as in JAX): the encoder convs
and BatchNorms, the GRU and the heads' convs compute in bf16; the warp, the
error map, the uncertainty volume, the bounds, the mask and the local
soft-argmin stay float32. ``LearnedBounds`` has no ``dtype``: JAX runs it
in float32 in a bf16 model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (
    disp_warp,
    local_soft_argmin,
    make_candidates,
    resize_bilinear,
    uncertainty_volume,
)
from .blocks import DeformBlock, ResBlock
from .conv import Conv
from .norm import BatchNorm2d
from .gru import ConvGRU


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _images_at(disp, left, right):
    """Downscale full-resolution images [B, H, W, 3] to the disparity's
    resolution (bilinear, align_corners=False)."""
    H, W = disp.shape[1:3]
    if left.shape[2] != W:
        left = resize_bilinear(left, (H, W), align_corners=False)
        right = resize_bilinear(right, (H, W), align_corners=False)
    return left, right


def _guidance(cur_disp, left, right, prob):
    """The photometric error map (the right image warped by the disparity,
    minus the left) and the uncertainty volume, both NCHW; the images at
    the disparity's resolution."""
    warped_left, _ = disp_warp(right, cur_disp)
    return (_nchw(warped_left - left),
            _nchw(uncertainty_volume(prob, cur_disp)))


class _ConvBnReLU(nn.Sequential):
    """conv3x3 (no bias), BatchNorm, ReLU; keys ``0``, ``1``. The norm
    reads the conv in float32 (``Conv2d.forward_f32``)."""

    def forward(self, x):
        conv, bn, relu = self
        return relu(bn(conv.forward_f32(x)))


def _conv_bn_relu(in_channels, out_channels, dtype=None):
    return _ConvBnReLU(
        Conv(in_channels, out_channels, 3, bias=False, dtype=dtype),
        BatchNorm2d(out_channels, dtype=dtype), nn.ReLU())


class GuidanceEncoder(nn.Module):
    """Encodes the photometric error map (right image warped by the current
    disparity, minus left) and the uncertainty volume into 2*hidden
    channels, concatenated [error, uncertainty]."""

    def __init__(self, num_bins: int, hidden: int = 32, dtype=None):
        super().__init__()
        self.disparity_error_encoder = _conv_bn_relu(3, hidden, dtype)
        self.uncertain_encoder = _conv_bn_relu(num_bins, hidden, dtype)

    def forward(self, cur_disp, left, right, prob):
        """cur_disp [B, H, W, 1]; left, right [B, H, W, 3] at the
        disparity's resolution; prob [B, H, W, D] -> [B, 2*hidden, H, W]."""
        error_map, uncert = _guidance(cur_disp, left, right, prob)
        return torch.cat([self.disparity_error_encoder(error_map),
                          self.uncertain_encoder(uncert)], dim=1)


class OffsetHead(nn.Module):
    """conv-ReLU-conv-ReLU -> 2 non-negative range offsets, float32 (the
    bounds are coordinates)."""

    def __init__(self, input_dim: int, hidden: int = 64, dtype=None):
        super().__init__()
        self.conv1 = Conv(input_dim, hidden, 3, dtype=dtype)
        self.conv2 = Conv(hidden, 2, 3, dtype=dtype)

    def forward(self, x):
        return F.relu(self.conv2(F.relu(self.conv1(x)))).float()


class GRUUpdate(nn.Module):
    """One refinement step: guidance -> ConvGRU -> bounds and convex-upsample
    mask -> candidates -> local soft-argmin over the volume.

    ``feature_dim > 0`` is the v2 step (``LowCNN_gru2``): a conv3x3 (no
    bias), BatchNorm and ReLU encode the left 1/8 feature (256 channels) to
    ``feature_dim`` channels, concatenated after the guidance, so the GRU,
    the mask head and the offset head read 2*hidden + feature_dim channels.
    Its modules are named after the JAX ones, ``feature_encode`` and
    ``feature_encode_bn``."""

    def __init__(self, num_bins: int, hidden: int = 32, num_samples: int = 20,
                 feature_dim: int = 0, dtype=None):
        super().__init__()
        gru_dim = 2 * hidden + feature_dim
        self.num_samples = num_samples
        self.encoder = GuidanceEncoder(num_bins, hidden, dtype)
        if feature_dim:
            self.feature_encode = Conv(256, feature_dim, 3, bias=False,
                                       dtype=dtype)
            self.feature_encode_bn = BatchNorm2d(feature_dim, dtype=dtype)
        self.gru = ConvGRU(gru_dim, gru_dim, dtype)
        self.offset = OffsetHead(gru_dim, dtype=dtype)
        self.mask = nn.Sequential(Conv(gru_dim, 256, 3, dtype=dtype),
                                  nn.ReLU(),
                                  Conv(256, 64 * 9, 1, dtype=dtype))

    def forward(self, volume, cur_disp, left, right, hidden, prob,
                left_feature=None):
        """volume, prob [B, H, W, D]; cur_disp [B, H, W, 1]; left, right
        [B, H, W, 3]; hidden [B, gru_dim, H, W] or None; left_feature
        [B, 256, H, W] (the v2 step only).

        Returns (disp [B, H, W, 1], hidden, mask [B, H, W, 576])."""
        feats = self.encoder(cur_disp, left, right, prob)
        if left_feature is not None:
            lf = self.feature_encode_bn(
                self.feature_encode.forward_f32(left_feature))
            feats = torch.cat([feats, F.relu(lf)], dim=1)
        hidden = self.gru(feats, hidden)
        # the mask logits are cast to float32 right after mask.2's bias add
        mask = 0.25 * _nhwc(self.mask[2].forward_f32(
            self.mask[1](self.mask[0](hidden))))
        bounds = _nhwc(self.offset(hidden))
        lower = cur_disp - bounds[..., 0:1]
        upper = cur_disp + bounds[..., 1:2]
        cands = make_candidates(lower, upper, cur_disp, self.num_samples,
                                volume.shape[-1])
        disp = local_soft_argmin(volume, cands.contiguous())
        return disp, hidden, mask


class SmallUNet(nn.Module):
    """The offset net of the learned bounds: conv-BN-ReLU encoders of the
    error map (3 -> hidden) and the uncertainty volume (D -> hidden),
    concatenated, a ResBlock, a DeformBlock to hidden/2, and
    relu(conv3x3 -> 2): the two offsets [B, 2, H, W].

    The reference's key names for this net are not at hand; the submodules
    are named after the JAX tree: ``error_encoder`` and
    ``uncertain_encoder`` (with their ``_bn`` as ``.1``), ``resblock``
    (``ResBlock_0``), ``deformblock`` (``DeformBlock_0``) and ``conv``
    (``Conv_0``)."""

    def __init__(self, num_bins: int, hidden: int = 32):
        super().__init__()
        self.error_encoder = _conv_bn_relu(3, hidden)
        self.uncertain_encoder = _conv_bn_relu(num_bins, hidden)
        self.resblock = ResBlock(2 * hidden, hidden)
        self.deformblock = DeformBlock(hidden, hidden // 2)
        self.conv = Conv(hidden // 2, 2, 3)

    def forward(self, error_map, uncert):
        x = torch.cat([self.error_encoder(error_map),
                       self.uncertain_encoder(uncert)], dim=1)
        return F.relu(self.conv(self.deformblock(self.resblock(x))))


class LearnedBounds(nn.Module):
    """Learned-bounds local cost volume: the error map of the right image
    warped by the current disparity and the uncertainty volume feed a
    ``SmallUNet``, whose two outputs are the bounds, absolute
    (``relative=False``) or around the current disparity (``relative=True``:
    lower = disp - out0, upper = disp + out1); candidates in them, then the
    local soft-argmin over the volume."""

    def __init__(self, num_bins: int, num_samples: int = 20,
                 relative: bool = False):
        super().__init__()
        self.num_samples, self.relative = num_samples, relative
        self.unet = SmallUNet(num_bins)

    def forward(self, volume, cur_disp, left, right, consider_valid=False):
        """volume [B, H, W, D]; cur_disp [B, H, W, 1]; left, right the
        full-resolution images [B, 8H, 8W, 3].

        Returns (disp [B, H, W, 1], (lower, upper) [B, H, W, 1] each)."""
        left, right = _images_at(cur_disp, left, right)
        off = _nhwc(self.unet(*_guidance(cur_disp, left, right,
                                         torch.softmax(volume, dim=-1))))
        lo_off, up_off = off[..., 0:1], off[..., 1:2]
        if self.relative:
            lower, upper = cur_disp - lo_off, cur_disp + up_off
        else:
            lower, upper = lo_off, up_off
        cands = make_candidates(lower, upper, cur_disp, self.num_samples,
                                volume.shape[-1],
                                consider_valid=consider_valid)
        return local_soft_argmin(volume, cands.contiguous()), (lower, upper)
