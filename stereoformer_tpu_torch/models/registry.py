"""Model registry of the port: names -> models on a device.

Counterpart of ``stereoformer_tpu/models/registry.py``. Only the names this
port has reached are here; the others raise.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..weights import seeded_state_dict
from .low_cnn import LowCNN
from .raft_stereo import RAFTStereo


def _raft(**kw):
    # the shared trainer/eval contract passes max_disp, loop and
    # ImageNet-normalised images; RAFT has no disparity cap and no
    # scan switch
    for k in ("max_disp", "loop", "scan_unroll"):
        kw.pop(k, None)
    kw.setdefault("input_norm", "imagenet")
    return RAFTStereo(**kw)


# name -> (constructor, the fan its seeded conv weights are scaled by, as
# the JAX model's init: he-normal over fan-in for LowCNN, fan-out for RAFT)
_PORTED = {"LowCNN_gru": (LowCNN, "fan_in"),
           "RAFT_Stereo": (_raft, "fan_out")}


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
    build, fan = _PORTED[name]
    with torch.device("meta"):
        model = build(**kwargs)
    model.load_state_dict(seeded_state_dict(model, fan=fan), assign=True)
    return model.to(dev).eval()
