"""RAFT-Stereo modules of the port (NCHW)."""

from .encoders import (
    BasicEncoder,
    GroupNorm,
    MultiBasicEncoder,
    RaftResidualBlock,
)
from .update import (
    CORR_LEVELS,
    CORR_RADIUS,
    FACTOR,
    HIDDEN,
    BasicMotionEncoder,
    ContextConvGRU,
    FlowHead,
    MultiUpdateBlock,
    interp_to,
    pool2x,
)

__all__ = [
    "CORR_LEVELS",
    "CORR_RADIUS",
    "FACTOR",
    "HIDDEN",
    "BasicEncoder",
    "BasicMotionEncoder",
    "ContextConvGRU",
    "FlowHead",
    "GroupNorm",
    "MultiBasicEncoder",
    "MultiUpdateBlock",
    "RaftResidualBlock",
    "interp_to",
    "pool2x",
]
