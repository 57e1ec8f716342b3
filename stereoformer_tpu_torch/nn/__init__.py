"""Modules of the port (NCHW inside; NHWC at the refinement heads' interfaces)."""

from .aggregation import ConvBn3D, Hourglass3D, cost_volume_pyramid
from .blocks import (
    ConvBnRelu,
    ConvLReLU,
    DeformBlock,
    DeformConv,
    FPNFusion,
    FusedConv,
    ResBlock,
)
from .conv import Conv, ConvTransposeSame
from .deform import (
    DeformConvV1,
    DeformConvV1Pack,
    DeformRoIPooling,
    DeformRoIPoolingPack,
    ModulatedDeformConv,
    ModulatedDeformNormal,
)
from .gru import ConvGRU, SepConvGRU
from .norm import BatchNorm2d
from .residual import ResSubmoduleAttention, SAModule
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
    "ConvBn3D",
    "ConvBnRelu",
    "ConvGRU",
    "ConvLReLU",
    "ConvTransposeSame",
    "DeformBlock",
    "DeformConv",
    "DeformConvV1",
    "DeformConvV1Pack",
    "DeformRoIPooling",
    "DeformRoIPoolingPack",
    "FPNFusion",
    "FusedConv",
    "GRUUpdate",
    "GuidanceEncoder",
    "Hourglass3D",
    "LearnedBounds",
    "ModulatedDeformConv",
    "ModulatedDeformNormal",
    "OffsetHead",
    "ResBlock",
    "ResSubmoduleAttention",
    "SAModule",
    "SepConvGRU",
    "SmallUNet",
    "cost_volume_pyramid",
]
