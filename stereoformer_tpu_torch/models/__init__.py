"""Models of the port."""

from .low_cnn import LowCNN
from .raft_stereo import RAFTStereo
from .registry import available_models, get_model

__all__ = ["LowCNN", "RAFTStereo", "available_models", "get_model"]
