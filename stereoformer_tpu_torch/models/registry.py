"""Model registry of the port: names -> models on a device.

Counterpart of ``stereoformer_tpu/models/registry.py``. Only the names this
port has reached are here; the others raise.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..weights import seeded_state_dict
from .low_cnn import LowCNN

_PORTED = {"LowCNN_gru": LowCNN}


def available_models():
    return sorted(_PORTED)


def get_model(name: str, device="cuda", **kwargs):
    """Build model ``name`` in eval mode on ``device`` (the GPU by default;
    ``device=None`` means the GPU too), with random weights made by numpy
    from seed 0 (``weights.seeded_state_dict``). Load trained weights with
    ``model.load_state_dict``."""
    if name not in _PORTED:
        raise ValueError(
            f"model {name!r} is not yet ported; ported: {available_models()}")
    dev = resolve_device(device)
    with torch.device("meta"):
        model = _PORTED[name](**kwargs)
    model.load_state_dict(seeded_state_dict(model), assign=True)
    return model.to(dev).eval()
