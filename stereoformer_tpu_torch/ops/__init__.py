"""Tensor ops of the port (NHWC layouts, as in ``stereoformer_tpu.ops``)."""

from .corr1d import allpairs_corr1d, corr_lookup, corr_pyramid
from .cost_volume import (
    correlation_volume,
    correlation_volume_backward,
    correlation_volume_plain,
)
from .deform import (
    bilinear_sample_2d,
    deform_columns,
    deform_conv_fused,
    modulated_deform_conv,
    modulated_deform_conv_windowed,
)
from .dw_conv import conv2d_dw, conv2d_dw_plain
from .fused_conv import (
    conv2d_fused,
    conv2d_fused_prologue,
    conv2d_fused_prologue_stats,
    conv2d_fused_stats,
    conv3x3_plain,
    fused_conv_backward,
)
from .local_volume import (
    local_soft_argmin,
    local_soft_argmin_backward_plain,
    local_soft_argmin_plain,
    make_candidates,
    resample_volume_hat,
)
from .pad import InputPadder
from .resize import resize_bilinear, scale_disp
from .softargmin import soft_argmin, uncertainty_volume
from .upsample import upsample_convex, upsample_convex8
from .warp import disp_warp

__all__ = [
    "InputPadder",
    "allpairs_corr1d",
    "bilinear_sample_2d",
    "conv2d_dw",
    "conv2d_dw_plain",
    "conv2d_fused",
    "conv2d_fused_prologue",
    "conv2d_fused_prologue_stats",
    "conv2d_fused_stats",
    "conv3x3_plain",
    "corr_lookup",
    "corr_pyramid",
    "correlation_volume",
    "correlation_volume_backward",
    "correlation_volume_plain",
    "deform_columns",
    "deform_conv_fused",
    "disp_warp",
    "fused_conv_backward",
    "local_soft_argmin",
    "local_soft_argmin_backward_plain",
    "local_soft_argmin_plain",
    "make_candidates",
    "modulated_deform_conv",
    "modulated_deform_conv_windowed",
    "resample_volume_hat",
    "resize_bilinear",
    "scale_disp",
    "soft_argmin",
    "uncertainty_volume",
    "upsample_convex",
    "upsample_convex8",
]
