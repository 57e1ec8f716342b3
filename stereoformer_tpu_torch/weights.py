"""Weights for the port's models: the bridge from the JAX parameter trees and
optimizer state, reference checkpoint files, and a seeded numpy init.

The port's ``state_dict`` uses the reference PyTorch key names, the ones
``stereoformer_tpu/train/torch_import.py`` reads: ``lowcnn_state_dict_from_jax``
is the inverse of its ``convert_lowcnn_state_dict``, and
``raft_state_dict_from_jax`` of its ``convert_raft_state_dict``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .nn.blocks import DeformConv
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
    """A ResBlock, or a DeformBlock (whose second conv is ``DeformConv_0``).
    Flax numbers a block's norms in call order and the shortcut runs
    first, so with a shortcut its norm is BatchNorm_0 and bn1/bn2 are
    BatchNorm_1/BatchNorm_2."""
    shortcut = "shortcut_conv" in params
    off = 1 if shortcut else 0
    _conv(sd, key + ".conv1", params["Conv_0"])
    _bn(sd, key + ".bn1", params[f"BatchNorm_{off}"],
        _at(stats, f"BatchNorm_{off}"))
    if "DeformConv_0" in params:
        _deform_conv(sd, key + ".conv2", params["DeformConv_0"])
    else:
        _conv(sd, key + ".conv2", params["Conv_1"])
    _bn(sd, key + ".bn2", params[f"BatchNorm_{off + 1}"],
        _at(stats, f"BatchNorm_{off + 1}"))
    if shortcut:
        _conv(sd, key + ".shortcut.0", params["shortcut_conv"])
        _bn(sd, key + ".shortcut.1", params["BatchNorm_0"],
            _at(stats, "BatchNorm_0"))


def lowcnn_state_dict_from_jax(variables) -> dict:
    """The JAX ``LowCNN`` variables ``{"params", "batch_stats"}`` (numpy
    leaves) of any refinement, upsample and cost volume -> the port's
    ``state_dict``. Without ``"batch_stats"``, the parameters' entries
    only.

    Kernels map HWIO -> OIHW, Dense kernels [in, out] -> [out, in]. The GRU
    step's fused gate conv ``conv_zb`` splits into ``conv_z`` and
    ``conv_b``; ``ConvAffinityUpsample_0`` maps to ``upsample_mask`` and
    ``LearnedBounds_0/SmallUNet_0`` to ``local_cost_volume.unet``. The keys
    of the concat volume's projections (``concat_proj1``, ``concat_proj2``)
    and of the v2 GRU step's feature encoder
    (``local_cost_volume.feature_encode``, ``..._bn``) are the JAX modules'
    names: the reference's names for them are not known, and these keys are
    not checked against a reference checkpoint."""
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
    for name in ("concat_proj1", "concat_proj2"):
        if name in p:
            sd[name + ".weight"] = _tensor(np.transpose(p[name]["kernel"]))
            sd[name + ".bias"] = _tensor(p[name]["bias"])

    if "gru_update" in p:
        _gru_head(sd, p["gru_update"], _at(s, "gru_update"))
    if "ConvAffinityUpsample_0" in p:
        mask = p["ConvAffinityUpsample_0"]
        _conv(sd, "upsample_mask.upsample_mask.0", mask["Conv_0"])
        _conv(sd, "upsample_mask.upsample_mask.2", mask["Conv_1"])
    if "LearnedBounds_0" in p:
        _smallunet(sd, "local_cost_volume.unet",
                   p["LearnedBounds_0"]["SmallUNet_0"],
                   _at(s, "LearnedBounds_0", "SmallUNet_0"))
    return sd


def _gru_head(sd, g, gs):
    """The GRU step (``gru_update``); the fused gate conv ``conv_zb`` splits
    into ``conv_z`` (first half of its outputs) and ``conv_b``; the v2
    step's ``feature_encode`` and its BatchNorm keep their JAX names."""
    enc = g["GuidanceEncoder_0"]
    encs = _at(gs, "GuidanceEncoder_0")
    key = "local_cost_volume.encoder"
    _conv(sd, key + ".disparity_error_encoder.0", enc["error_encoder"], bias=False)
    _bn(sd, key + ".disparity_error_encoder.1", enc["error_encoder_bn"],
        _at(encs, "error_encoder_bn"))
    _conv(sd, key + ".uncertain_encoder.0", enc["uncertain_encoder"], bias=False)
    _bn(sd, key + ".uncertain_encoder.1", enc["uncertain_encoder_bn"],
        _at(encs, "uncertain_encoder_bn"))
    if "feature_encode" in g:
        key = "local_cost_volume.feature_encode"
        _conv(sd, key, g["feature_encode"], bias=False)
        _bn(sd, key + "_bn", g["feature_encode_bn"],
            _at(gs, "feature_encode_bn"))
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


def _deform_conv(sd, key, node):
    """DeformConv: ``offset_mask`` -> ``conv_offset_mask``; the weight
    [K*C, Co], tap-major (ky, kx, cin), -> [Co, C, k, k]."""
    _conv(sd, key + ".conv_offset_mask", node["offset_mask"])
    k, _, C, _ = np.shape(node["offset_mask"]["kernel"])
    w = np.asarray(node["weight"])
    sd[key + ".weight"] = _tensor(
        np.transpose(w.reshape(k, k, C, w.shape[1]), (3, 2, 0, 1)))
    sd[key + ".bias"] = _tensor(node["bias"])


def _smallunet(sd, key, p, s):
    """SmallUNet: encoders, ResBlock_0, DeformBlock_0 and Conv_0."""
    for enc in ("error_encoder", "uncertain_encoder"):
        _conv(sd, f"{key}.{enc}.0", p[enc], bias=False)
        _bn(sd, f"{key}.{enc}.1", p[enc + "_bn"], _at(s, enc + "_bn"))
    _resblock(sd, key + ".resblock", p["ResBlock_0"], _at(s, "ResBlock_0"))
    _resblock(sd, key + ".deformblock", p["DeformBlock_0"],
              _at(s, "DeformBlock_0"))
    _conv(sd, key + ".conv", p["Conv_0"])


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
    """optax's AMSGrad state for the JAX ``LowCNN(refinement="gru")`` or
    ``RAFTStereo`` (``optax.amsgrad``'s chain state, or any tuple nesting
    that holds its ``ScaleByAmsgradState``) -> the port's ``AmsgradState``
    for ``model``, on the model's device. ``mu``, ``nu`` and ``nu_max`` map
    as the parameters do (``raft_state_dict_from_jax`` for a
    ``RAFTStereo``, else ``lowcnn_state_dict_from_jax``), so a JAX run goes
    on in the port."""
    from .models.raft_stereo import RAFTStereo   # models import this module

    state = _find_amsgrad(opt_state)
    if state is None:
        raise ValueError("no AMSGrad state (with nu_max) in opt_state")
    params = dict(model.named_parameters())
    to_state_dict = (raft_state_dict_from_jax if isinstance(model, RAFTStereo)
                     else lowcnn_state_dict_from_jax)

    def moments(tree):
        sd = to_state_dict({"params": tree})
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
    conv weight (a ``DeformConv``'s too) and linear weight plain normal,
    he-scaled over its ``fan`` ("fan_in", as LowCNN's init, or "fan_out",
    as RAFT's), biases zero, BatchNorm the identity (scale 1, shift 0,
    mean 0, variance 1), a ``DeformConv``'s ``conv_offset_mask`` zero (so
    it starts as a plain conv modulated by 0.5). It is the registry's
    init, and the tests' and ``chip_smoke.py``'s, whose values depend on
    it; the trainer starts from ``init_state_dict``, the JAX models'
    distributions."""
    rng = np.random.default_rng(seed)

    def weight(name, shape, fans):
        n = fans[fan] * int(np.prod(shape[2:]))
        return rng.standard_normal(shape) * np.sqrt(2.0 / n)

    return _random_state_dict(model, weight)


# LowCNN's GRU gate convs, drawn orthogonal by the JAX model
_GRU_GATES = re.compile(r"local_cost_volume\.gru\.conv_[zbg]")
# flax's truncated normal keeps |z| <= 2 and divides the standard deviation
# by that truncation's, so the variance is the one asked for
_TRUNC_STD = 0.87962566103423978


def init_state_dict(model: torch.nn.Module, seed: int = 0) -> dict:
    """Random weights for ``model`` from numpy, made from ``seed``, drawn
    from the distributions the JAX models' own inits draw from (not their
    values): conv, deformable-conv and linear weights truncated normal (at
    two standard deviations) with variance 2 / fan, over the fan-in for
    LowCNN (``nn.initializers.he_normal``) and over the fan-out for RAFT
    (``nn/raft/encoders.py::he_out``); LowCNN's GRU gate convs ``conv_z``,
    ``conv_b`` and ``conv_g`` orthogonal, each on its own (the JAX
    ``conv_zb`` is two orthogonal kernels side by side,
    ``nn/gru.py::stacked_orthogonal``); biases zero; BatchNorm the
    identity; ``conv_offset_mask`` zero. The trainer's from-scratch
    init."""
    from .models.raft_stereo import RAFTStereo   # models import this module

    rng = np.random.default_rng(seed)
    fan = "fan_out" if isinstance(model, RAFTStereo) else "fan_in"

    def weight(name, shape, fans):
        if _GRU_GATES.fullmatch(name):
            return _orthogonal(rng, shape)
        n = fans[fan] * int(np.prod(shape[2:]))
        return _truncated_normal(rng, shape) * np.float32(
            np.sqrt(2.0 / n) / _TRUNC_STD)

    return _random_state_dict(model, weight)


def _truncated_normal(rng, shape) -> np.ndarray:
    """Standard normal values redrawn until each lies in [-2, 2]."""
    z = rng.standard_normal(shape, dtype=np.float32)
    out = np.flatnonzero(np.abs(z) > 2)
    while out.size:
        z.flat[out] = rng.standard_normal(out.size, dtype=np.float32)
        out = out[np.abs(z.flat[out]) > 2]
    return z


def _orthogonal(rng, shape) -> np.ndarray:
    """flax's ``orthogonal()`` for the HWIO kernel of an OIHW ``shape``:
    the kernel flattened to [kh*kw*C_in, C_out] has orthonormal columns
    (rows where it is wide), from the QR of a normal matrix with the signs
    of R's diagonal."""
    co, ci, kh, kw = shape
    rows = kh * kw * ci
    a = rng.standard_normal((rows, co) if rows >= co else (co, rows))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if rows < co:
        q = q.T
    return np.transpose(q.reshape(kh, kw, ci, co), (3, 2, 0, 1))


def _random_state_dict(model: torch.nn.Module, weight) -> dict:
    """The ``state_dict`` of ``model`` with ``weight(name, shape, fans)``
    for each conv and linear weight, in module order; see
    ``seeded_state_dict`` for the rest."""
    sd = {}
    for name, m in model.named_modules():
        key = name + "." if name else ""
        if name.endswith("conv_offset_mask"):
            sd[key + "weight"] = torch.zeros(m.weight.shape)
            sd[key + "bias"] = torch.zeros(m.out_channels)
        elif isinstance(m, (torch.nn.Conv2d, DeformConv, torch.nn.Linear)):
            shape = tuple(m.weight.shape)
            fans = {"fan_in": shape[1], "fan_out": shape[0]}
            sd[key + "weight"] = _tensor(weight(name, shape, fans))
            if m.bias is not None:
                sd[key + "bias"] = torch.zeros(m.bias.shape)
        elif isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            sd[key + "weight"] = torch.ones(n)
            sd[key + "bias"] = torch.zeros(n)
            sd[key + "running_mean"] = torch.zeros(n)
            sd[key + "running_var"] = torch.ones(n)
            sd[key + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
