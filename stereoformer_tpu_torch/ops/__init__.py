"""Tensor ops of the port (NHWC layouts, as in ``stereoformer_tpu.ops``)."""

from .cost_volume import (
    correlation_volume,
    correlation_volume_backward,
    correlation_volume_plain,
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
from .upsample import upsample_convex8
from .warp import disp_warp

__all__ = [
    "InputPadder",
    "correlation_volume",
    "correlation_volume_backward",
    "correlation_volume_plain",
    "disp_warp",
    "local_soft_argmin",
    "local_soft_argmin_backward_plain",
    "local_soft_argmin_plain",
    "make_candidates",
    "resample_volume_hat",
    "resize_bilinear",
    "scale_disp",
    "soft_argmin",
    "uncertainty_volume",
    "upsample_convex8",
]
