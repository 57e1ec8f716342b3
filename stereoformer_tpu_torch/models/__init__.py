"""Models of the port."""

from .low_cnn import LowCNN
from .registry import available_models, get_model

__all__ = ["LowCNN", "available_models", "get_model"]
