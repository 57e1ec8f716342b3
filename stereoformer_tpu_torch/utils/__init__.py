"""Logging, the loss-schedule file, meters and disparity panels."""

from .common import AverageMeter, get_logger, load_loss_scheme
from .viz import disp_error_image, kitti_colormap, tensorboard_disparity_images

__all__ = [
    "AverageMeter",
    "disp_error_image",
    "get_logger",
    "kitti_colormap",
    "load_loss_scheme",
    "tensorboard_disparity_images",
]
