"""RAFT-Stereo modules of the port (NCHW)."""

from .encoders import (
    BasicEncoder,
    BottleneckBlock,
    GroupNorm,
    MultiBasicEncoder,
    RaftResidualBlock,
)
from .update import (
    BasicMotionEncoder,
    ContextConvGRU,
    FlowHead,
    MultiUpdateBlock,
    interp_to,
    pool2x,
)

__all__ = [
    "BasicEncoder",
    "BasicMotionEncoder",
    "BottleneckBlock",
    "ContextConvGRU",
    "FlowHead",
    "GroupNorm",
    "MultiBasicEncoder",
    "MultiUpdateBlock",
    "RaftResidualBlock",
    "interp_to",
    "pool2x",
]
