"""Tensor ops of the port (NHWC layouts, as in ``stereoformer_tpu.ops``)."""

from .attention import banded_attention, banded_attention_scores
from .corr1d import allpairs_corr1d, corr_lookup, corr_pyramid
from .cost_volume import (
    concat_volume,
    correlation_volume,
    correlation_volume_backward,
    correlation_volume_plain,
    gwc_volume,
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
    conv2d_fused_s2,
    conv3x3_plain,
    conv3x3_s2_plain,
    fused_conv_backward,
)
from .gather import take_rows, take_rows_plain
from .local_volume import (
    fixed_local_cost_volume,
    local_soft_argmin,
    local_soft_argmin_backward_plain,
    local_soft_argmin_plain,
    make_candidates,
    resample_volume_hat,
    variance_local_cost_volume,
)
from .pad import InputPadder
from .resize import resize_bilinear, scale_disp
from .softargmin import disparity_variance, soft_argmin, uncertainty_volume
from .upsample import upsample_convex, upsample_convex8, upsample_simple8
from .warp import disp_warp

__all__ = [
    "InputPadder",
    "allpairs_corr1d",
    "banded_attention",
    "banded_attention_scores",
    "bilinear_sample_2d",
    "concat_volume",
    "conv2d_dw",
    "conv2d_dw_plain",
    "conv2d_fused",
    "conv2d_fused_prologue",
    "conv2d_fused_prologue_stats",
    "conv2d_fused_s2",
    "conv2d_fused_stats",
    "conv3x3_plain",
    "conv3x3_s2_plain",
    "corr_lookup",
    "corr_pyramid",
    "correlation_volume",
    "correlation_volume_backward",
    "correlation_volume_plain",
    "deform_columns",
    "deform_conv_fused",
    "disp_warp",
    "disparity_variance",
    "fixed_local_cost_volume",
    "fused_conv_backward",
    "gwc_volume",
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
    "take_rows",
    "take_rows_plain",
    "uncertainty_volume",
    "upsample_convex",
    "upsample_convex8",
    "upsample_simple8",
    "variance_local_cost_volume",
]
