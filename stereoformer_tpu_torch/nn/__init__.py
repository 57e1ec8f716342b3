"""Modules of the port (NCHW inside; NHWC at the GRU step's interface)."""

from .blocks import ConvBnRelu, ConvLReLU, FPNFusion, ResBlock
from .conv import Conv
from .gru import ConvGRU
from .update import GRUUpdate, GuidanceEncoder, OffsetHead

__all__ = [
    "Conv",
    "ConvBnRelu",
    "ConvGRU",
    "ConvLReLU",
    "FPNFusion",
    "GRUUpdate",
    "GuidanceEncoder",
    "OffsetHead",
    "ResBlock",
]
