"""Model registry of the port: names -> models on a device.

Counterpart of ``stereoformer_tpu/models/registry.py``, with all of its
names: the LowCNN family (``LowCNN``, ``LowCNN_simple``, ``LowCNN_ada``,
``LowCNN_dynamic``, ``LowCNN_dynamic_supervised``, ``LowCNN_gru``,
``LowCNN_gru2``), ``RAFT_Stereo`` and ``CrossAttentionStereo``; any other
name raises.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..weights import seeded_state_dict
from .cross_attention import CrossAttentionStereo
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


def _cross_attention(**kw):
    # its GRU refinement is always unrolled
    for k in ("loop", "scan_unroll"):
        kw.pop(k, None)
    return CrossAttentionStereo(**kw)


def _lowcnn(refinement):
    def build(**kw):
        kw.setdefault("refinement", refinement)
        return LowCNN(**kw)
    return build


# name -> (constructor, the fan its seeded conv weights are scaled by, as
# the JAX model's init: he-normal over fan-in for LowCNN and
# CrossAttentionStereo, fan-out for RAFT)
_PORTED = {"LowCNN": (_lowcnn("fixed"), "fan_in"),
           "LowCNN_simple": (_lowcnn("none"), "fan_in"),
           "LowCNN_ada": (_lowcnn("variance"), "fan_in"),
           "LowCNN_gru": (_lowcnn("gru"), "fan_in"),
           "LowCNN_gru2": (_lowcnn("gru_feature"), "fan_in"),
           "LowCNN_dynamic": (_lowcnn("learned"), "fan_in"),
           "LowCNN_dynamic_supervised": (_lowcnn("learned_supervised"),
                                         "fan_in"),
           "RAFT_Stereo": (_raft, "fan_out"),
           "CrossAttentionStereo": (_cross_attention, "fan_in")}


def available_models():
    return sorted(_PORTED)


def get_model(name: str, device="cuda", **kwargs):
    """Build model ``name`` in eval mode on ``device`` (the GPU by default;
    ``device=None`` means the GPU too), with random weights made by numpy
    from seed 0 (``weights.seeded_state_dict``). Load trained weights with
    ``model.load_state_dict``."""
    if name not in _PORTED:
        raise ValueError(
            f"unknown model {name!r}; available: {available_models()}")
    dev = resolve_device(device)
    build, fan = _PORTED[name]
    with torch.device("meta"):
        model = build(**kwargs)
    model.load_state_dict(seeded_state_dict(model, fan=fan), assign=True)
    return model.to(dev).eval()
