"""Models of the port."""

from .cross_attention import CrossAttentionStereo
from .low_cnn import LowCNN
from .raft_stereo import RAFTStereo
from .registry import available_models, get_model

__all__ = ["CrossAttentionStereo", "LowCNN", "RAFTStereo", "available_models", "get_model"]
