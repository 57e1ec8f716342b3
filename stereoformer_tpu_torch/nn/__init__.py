"""Modules of the port (NCHW inside; NHWC at the refinement heads' interfaces)."""

from .blocks import (
    ConvBnRelu,
    ConvLReLU,
    DeformBlock,
    DeformConv,
    FPNFusion,
    FusedConv,
    ResBlock,
)
from .conv import Conv
from .gru import ConvGRU
from .norm import BatchNorm2d
from .update import (
    GRUUpdate,
    GuidanceEncoder,
    LearnedBounds,
    OffsetHead,
    SmallUNet,
)

__all__ = [
    "BatchNorm2d",
    "Conv",
    "ConvBnRelu",
    "ConvGRU",
    "ConvLReLU",
    "DeformBlock",
    "DeformConv",
    "FPNFusion",
    "FusedConv",
    "GRUUpdate",
    "GuidanceEncoder",
    "LearnedBounds",
    "OffsetHead",
    "ResBlock",
    "SmallUNet",
]
