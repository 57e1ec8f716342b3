"""Modules of the port (NCHW inside; NHWC at the GRU step's interface)."""

from .blocks import ConvBnRelu, ConvLReLU, FPNFusion, FusedConv, ResBlock
from .conv import Conv
from .gru import ConvGRU
from .norm import BatchNorm2d
from .update import GRUUpdate, GuidanceEncoder, OffsetHead

__all__ = [
    "BatchNorm2d",
    "Conv",
    "ConvBnRelu",
    "ConvGRU",
    "ConvLReLU",
    "FPNFusion",
    "FusedConv",
    "GRUUpdate",
    "GuidanceEncoder",
    "OffsetHead",
    "ResBlock",
]
