"""Weights for the port's LowCNN: the bridge from the JAX parameter tree,
reference checkpoint files, and a seeded numpy init.

The port's ``state_dict`` uses the reference PyTorch key names, the ones
``stereoformer_tpu/train/torch_import.py::convert_lowcnn_state_dict`` reads:
``lowcnn_state_dict_from_jax`` is that converter's inverse.
"""

from __future__ import annotations

import numpy as np
import torch

# reference prefix -> Flax module name, for the backbone's ResBlocks
_BACKBONE = (("conv2", "ResBlock_0"), ("conv3", "ResBlock_1"),
             ("downsample1", "ResBlock_2"), ("downsample2", "ResBlock_3"),
             ("downsample3", "ResBlock_4"))
# duplicate keys of reference checkpoints: Sequential aliases of conv_z/b/g
_ALIASES = ("local_cost_volume.gru.conv_zz.0.", "local_cost_volume.gru.conv_bb.0.",
            "local_cost_volume.gru.conv_gg.0.")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _conv(sd, key, node, bias=True):
    sd[key + ".weight"] = _tensor(np.transpose(node["kernel"], (3, 2, 0, 1)))
    if bias:
        sd[key + ".bias"] = _tensor(node["bias"])


def _bn(sd, key, params, stats):
    sd[key + ".weight"] = _tensor(params["scale"])
    sd[key + ".bias"] = _tensor(params["bias"])
    sd[key + ".running_mean"] = _tensor(stats["mean"])
    sd[key + ".running_var"] = _tensor(stats["var"])
    sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _resblock(sd, key, params, stats):
    """Flax numbers a ResBlock's norms in call order and the shortcut runs
    first, so with a shortcut its norm is BatchNorm_0 and bn1/bn2 are
    BatchNorm_1/BatchNorm_2."""
    shortcut = "shortcut_conv" in params
    off = 1 if shortcut else 0
    _conv(sd, key + ".conv1", params["Conv_0"])
    _bn(sd, key + ".bn1", params[f"BatchNorm_{off}"], stats[f"BatchNorm_{off}"])
    _conv(sd, key + ".conv2", params["Conv_1"])
    _bn(sd, key + ".bn2", params[f"BatchNorm_{off + 1}"],
        stats[f"BatchNorm_{off + 1}"])
    if shortcut:
        _conv(sd, key + ".shortcut.0", params["shortcut_conv"])
        _bn(sd, key + ".shortcut.1", params["BatchNorm_0"], stats["BatchNorm_0"])


def lowcnn_state_dict_from_jax(variables) -> dict:
    """The JAX ``LowCNN(refinement="gru")`` variables ``{"params",
    "batch_stats"}`` (numpy leaves) -> the port's ``state_dict``.

    Kernels map HWIO -> OIHW; the fused GRU gate conv ``conv_zb`` splits
    into ``conv_z`` (first half of its outputs) and ``conv_b``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: dict = {}
    _conv(sd, "conv1.0", p["ConvLReLU_0"]["Conv_0"])
    for key, name in _BACKBONE:
        _resblock(sd, key, p[name], s[name])
    for i in range(2):
        node, stats = p["FPNFusion_0"][f"ConvBnRelu_{i}"], s["FPNFusion_0"][f"ConvBnRelu_{i}"]
        _conv(sd, f"feature_concated.layer_list.{i}.conv", node["Conv_0"],
              bias=False)
        _bn(sd, f"feature_concated.layer_list.{i}.bn", node["BatchNorm_0"],
            stats["BatchNorm_0"])
    for i in range(3):
        _resblock(sd, f"correlation_aggreagtion.{i}", p[f"agg{i}"], s[f"agg{i}"])

    g, gs = p["gru_update"], s["gru_update"]
    enc, encs = g["GuidanceEncoder_0"], gs["GuidanceEncoder_0"]
    key = "local_cost_volume.encoder"
    _conv(sd, key + ".disparity_error_encoder.0", enc["error_encoder"], bias=False)
    _bn(sd, key + ".disparity_error_encoder.1", enc["error_encoder_bn"],
        encs["error_encoder_bn"])
    _conv(sd, key + ".uncertain_encoder.0", enc["uncertain_encoder"], bias=False)
    _bn(sd, key + ".uncertain_encoder.1", enc["uncertain_encoder_bn"],
        encs["uncertain_encoder_bn"])
    zb = g["ConvGRU_0"]["conv_zb"]
    hidden = np.shape(zb["bias"])[0] // 2
    for part, cut in (("conv_z", slice(0, hidden)), ("conv_b", slice(hidden, None))):
        _conv(sd, f"local_cost_volume.gru.{part}",
              {"kernel": np.asarray(zb["kernel"])[..., cut],
               "bias": np.asarray(zb["bias"])[cut]})
    _conv(sd, "local_cost_volume.gru.conv_g", g["ConvGRU_0"]["conv_g"])
    _conv(sd, "local_cost_volume.offset.conv1", g["OffsetHead_0"]["Conv_0"])
    _conv(sd, "local_cost_volume.offset.conv2", g["OffsetHead_0"]["Conv_1"])
    _conv(sd, "local_cost_volume.mask.0", g["mask_conv1"])
    _conv(sd, "local_cost_volume.mask.2", g["mask_conv2"])
    return sd


def load_state_dict_file(path: str) -> dict:
    """A port or reference ``.pth`` state_dict, read with
    ``torch.load(weights_only=True)``: unwraps ``{"state_dict": ...}``,
    strips DataParallel's ``module.`` prefix and drops the reference's
    duplicate GRU alias keys."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return {k: v for k, v in sd.items() if not k.startswith(_ALIASES)}


def seeded_state_dict(model: torch.nn.Module, seed: int = 0) -> dict:
    """Random weights for ``model`` from numpy, made from ``seed``: each
    conv weight he-normal over its fan-in, biases zero, BatchNorm the
    identity (scale 1, shift 0, mean 0, variance 1), as the JAX model's own
    init draws them (its GRU gates, drawn orthogonal there, are he-normal
    here)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            shape = tuple(m.weight.shape)
            fan_in = shape[1] * shape[2] * shape[3]
            sd[name + ".weight"] = _tensor(
                rng.standard_normal(shape) * np.sqrt(2.0 / fan_in))
            if m.bias is not None:
                sd[name + ".bias"] = torch.zeros(m.out_channels)
        elif isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            sd[name + ".weight"] = torch.ones(n)
            sd[name + ".bias"] = torch.zeros(n)
            sd[name + ".running_mean"] = torch.zeros(n)
            sd[name + ".running_var"] = torch.ones(n)
            sd[name + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
