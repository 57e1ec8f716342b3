"""Sample-dict image transforms (numpy, NHWC float32).

Counterpart of ``to_unit`` and ``normalize`` in
``stereoformer_tpu/data/transforms.py``.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_IMG_KEYS = ("img_left", "img_right")


def to_unit(sample: dict) -> dict:
    """Scale the images from 0..255 to 0..1."""
    for k in _IMG_KEYS:
        sample[k] = sample[k].astype(np.float32) / 255.0
    return sample


def normalize(sample: dict, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> dict:
    """ImageNet normalisation of the images."""
    for k in _IMG_KEYS:
        sample[k] = (sample[k] - mean) / std
    return sample
