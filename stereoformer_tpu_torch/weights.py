"""Weights for the port's models: the bridge from the JAX parameter trees and
optimizer state, reference checkpoint files, and a seeded numpy init.

The port's ``state_dict`` uses the reference PyTorch key names, the ones
``stereoformer_tpu/train/torch_import.py`` reads: ``lowcnn_state_dict_from_jax``
is the inverse of its ``convert_lowcnn_state_dict``, and
``raft_state_dict_from_jax`` of its ``convert_raft_state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch

from .train.optim import AmsgradState

# reference prefix -> Flax module name, for the backbone's ResBlocks
_BACKBONE = (("conv2", "ResBlock_0"), ("conv3", "ResBlock_1"),
             ("downsample1", "ResBlock_2"), ("downsample2", "ResBlock_3"),
             ("downsample3", "ResBlock_4"))
# duplicate keys of reference checkpoints: Sequential aliases of LowCNN's
# conv_z/b/g, and of each RAFT residual block's norm3 (``downsample.1``)
_ALIASES = ("local_cost_volume.gru.conv_zz.0.", "local_cost_volume.gru.conv_bb.0.",
            "local_cost_volume.gru.conv_gg.0.")
_RAFT_ALIAS = ".downsample.1."


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _conv(sd, key, node, bias=True):
    sd[key + ".weight"] = _tensor(np.transpose(node["kernel"], (3, 2, 0, 1)))
    if bias:
        sd[key + ".bias"] = _tensor(node["bias"])


def _at(tree, *path):
    """tree[path[0]][path[1]]...; None where the tree is None."""
    for k in path:
        if tree is None:
            return None
        tree = tree[k]
    return tree


def _bn(sd, key, params, stats):
    sd[key + ".weight"] = _tensor(params["scale"])
    sd[key + ".bias"] = _tensor(params["bias"])
    if stats is not None:
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
    _bn(sd, key + ".bn1", params[f"BatchNorm_{off}"],
        _at(stats, f"BatchNorm_{off}"))
    _conv(sd, key + ".conv2", params["Conv_1"])
    _bn(sd, key + ".bn2", params[f"BatchNorm_{off + 1}"],
        _at(stats, f"BatchNorm_{off + 1}"))
    if shortcut:
        _conv(sd, key + ".shortcut.0", params["shortcut_conv"])
        _bn(sd, key + ".shortcut.1", params["BatchNorm_0"],
            _at(stats, "BatchNorm_0"))


def lowcnn_state_dict_from_jax(variables) -> dict:
    """The JAX ``LowCNN(refinement="gru")`` variables ``{"params",
    "batch_stats"}`` (numpy leaves) -> the port's ``state_dict``. Without
    ``"batch_stats"``, the parameters' entries only.

    Kernels map HWIO -> OIHW; the fused GRU gate conv ``conv_zb`` splits
    into ``conv_z`` (first half of its outputs) and ``conv_b``."""
    p, s = variables["params"], variables.get("batch_stats")
    sd: dict = {}
    _conv(sd, "conv1.0", p["ConvLReLU_0"]["Conv_0"])
    for key, name in _BACKBONE:
        _resblock(sd, key, p[name], _at(s, name))
    for i in range(2):
        node = p["FPNFusion_0"][f"ConvBnRelu_{i}"]
        _conv(sd, f"feature_concated.layer_list.{i}.conv", node["Conv_0"],
              bias=False)
        _bn(sd, f"feature_concated.layer_list.{i}.bn", node["BatchNorm_0"],
            _at(s, "FPNFusion_0", f"ConvBnRelu_{i}", "BatchNorm_0"))
    for i in range(3):
        _resblock(sd, f"correlation_aggreagtion.{i}", p[f"agg{i}"],
                  _at(s, f"agg{i}"))

    g = p["gru_update"]
    enc = g["GuidanceEncoder_0"]
    encs = _at(s, "gru_update", "GuidanceEncoder_0")
    key = "local_cost_volume.encoder"
    _conv(sd, key + ".disparity_error_encoder.0", enc["error_encoder"], bias=False)
    _bn(sd, key + ".disparity_error_encoder.1", enc["error_encoder_bn"],
        _at(encs, "error_encoder_bn"))
    _conv(sd, key + ".uncertain_encoder.0", enc["uncertain_encoder"], bias=False)
    _bn(sd, key + ".uncertain_encoder.1", enc["uncertain_encoder_bn"],
        _at(encs, "uncertain_encoder_bn"))
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


def _raft_block(sd, key, params, stats, shortcut: bool, bn: bool):
    """A RaftResidualBlock: the norms are numbered in declaration order
    (_Norm_0 = norm1, _Norm_1 = norm2, _Norm_2 = the shortcut's norm3);
    instance norms have no parameters."""
    _conv(sd, key + ".conv1", params["Conv_0"])
    _conv(sd, key + ".conv2", params["Conv_1"])
    norms = [("norm1", "_Norm_0"), ("norm2", "_Norm_1")]
    if shortcut:
        _conv(sd, key + ".downsample.0", params["downsample"])
        norms.append(("norm3", "_Norm_2"))
    if bn:
        for ours, theirs in norms:
            _bn(sd, f"{key}.{ours}", params[theirs]["BatchNorm_0"],
                _at(stats, theirs, "BatchNorm_0"))


def raft_state_dict_from_jax(variables) -> dict:
    """The JAX ``RAFTStereo`` variables ``{"params", "batch_stats"}`` (numpy
    leaves) -> the port's ``state_dict``. Without ``"batch_stats"``, the
    parameters' entries only.

    Kernels map HWIO -> OIHW; each GRU's fused gate conv ``convzr`` splits
    into ``convz`` (first half of its outputs) and ``convr``."""
    p, s = variables["params"], variables.get("batch_stats")
    sd: dict = {}
    fnet = p["fnet"]
    _conv(sd, "fnet.conv1", fnet["Conv_0"])
    for n in (1, 2, 3):
        for i, half in enumerate("ab"):
            _raft_block(sd, f"fnet.layer{n}.{i}", fnet[f"layer{n}{half}"],
                        None, shortcut=n > 1 and i == 0, bn=False)
    _conv(sd, "fnet.conv2", fnet["Conv_1"])

    cnet, cs = p["cnet"], _at(s, "cnet")
    _conv(sd, "cnet.conv1", cnet["Conv_0"])
    _bn(sd, "cnet.norm1", cnet["_Norm_0"]["BatchNorm_0"],
        _at(cs, "_Norm_0", "BatchNorm_0"))
    for n, ours in ((1, "layer1"), (2, "layer2"), (3, "layer3"),
                    (4, "down1"), (5, "down2")):
        for i, half in enumerate("ab"):
            _raft_block(sd, f"cnet.layer{n}.{i}", cnet[f"{ours}{half}"],
                        _at(cs, f"{ours}{half}"), shortcut=n > 1 and i == 0,
                        bn=True)
    for scale, lvl in (("08", 0), ("16", 1)):
        for h in range(2):
            _raft_block(sd, f"cnet.outputs{scale}.{h}.0",
                        cnet[f"out{lvl}_{h}_res"],
                        _at(cs, f"out{lvl}_{h}_res"), shortcut=False, bn=True)
            _conv(sd, f"cnet.outputs{scale}.{h}.1", cnet[f"out{lvl}_{h}_conv"])
    for h in range(2):
        _conv(sd, f"cnet.outputs32.{h}", cnet[f"out2_{h}_conv"])

    ub = p["update_block"]
    for i, name in enumerate(("convc1", "convc2", "convf1", "convf2", "conv")):
        _conv(sd, f"update_block.encoder.{name}", ub["encoder"][f"Conv_{i}"])
    for g in ("gru08", "gru16", "gru32"):
        zr = ub[g]["convzr"]
        hidden = np.shape(zr["bias"])[0] // 2
        for part, cut in (("convz", slice(0, hidden)),
                          ("convr", slice(hidden, None))):
            _conv(sd, f"update_block.{g}.{part}",
                  {"kernel": np.asarray(zr["kernel"])[..., cut],
                   "bias": np.asarray(zr["bias"])[cut]})
        _conv(sd, f"update_block.{g}.convq", ub[g]["convq"])
    _conv(sd, "update_block.flow_head.conv1", ub["flow_head"]["Conv_0"])
    _conv(sd, "update_block.flow_head.conv2", ub["flow_head"]["Conv_1"])
    _conv(sd, "update_block.mask.0", ub["mask_conv1"])
    _conv(sd, "update_block.mask.2", ub["mask_conv2"])
    for i in range(3):
        _conv(sd, f"context_zqr_convs.{i}", p[f"context_zqr{i}"])
    return sd


def amsgrad_state_from_jax(opt_state, model: torch.nn.Module) -> AmsgradState:
    """optax's AMSGrad state for the JAX ``LowCNN(refinement="gru")``
    (``optax.amsgrad``'s chain state, or any tuple nesting that holds its
    ``ScaleByAmsgradState``) -> the port's ``AmsgradState`` for ``model``,
    on the model's device. ``mu``, ``nu`` and ``nu_max`` map as the
    parameters do (``lowcnn_state_dict_from_jax``), so a JAX run goes on in
    the port."""
    state = _find_amsgrad(opt_state)
    if state is None:
        raise ValueError("no AMSGrad state (with nu_max) in opt_state")
    params = dict(model.named_parameters())

    def moments(tree):
        sd = lowcnn_state_dict_from_jax({"params": tree})
        return {k: sd[k].to(p.device) for k, p in params.items()}

    return AmsgradState(count=int(state.count), mu=moments(state.mu),
                        nu=moments(state.nu), nu_max=moments(state.nu_max))


def _find_amsgrad(state):
    if hasattr(state, "nu_max"):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_amsgrad(s)
            if found is not None:
                return found
    return None


def load_state_dict_file(path: str) -> dict:
    """A port or reference ``.pth`` state_dict, read with
    ``torch.load(weights_only=True)``: unwraps ``{"state_dict": ...}``,
    strips DataParallel's ``module.`` prefix and drops the reference's
    duplicate alias keys (LowCNN's GRU convs, RAFT's ``downsample.1``
    norms)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if not k.startswith(_ALIASES) and _RAFT_ALIAS not in k}


def seeded_state_dict(model: torch.nn.Module, seed: int = 0,
                      fan: str = "fan_in") -> dict:
    """Random weights for ``model`` from numpy, made from ``seed``: each
    conv weight he-normal over its ``fan`` ("fan_in", as LowCNN's init, or
    "fan_out", as RAFT's), biases zero, BatchNorm the identity (scale 1,
    shift 0, mean 0, variance 1), as the JAX models' own inits draw them
    (LowCNN's GRU gates, drawn orthogonal there, and RAFT's weights, drawn
    from a truncated normal there, are plain normal here)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            shape = tuple(m.weight.shape)
            fans = {"fan_in": shape[1], "fan_out": shape[0]}
            n = fans[fan] * shape[2] * shape[3]
            sd[name + ".weight"] = _tensor(
                rng.standard_normal(shape) * np.sqrt(2.0 / n))
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
