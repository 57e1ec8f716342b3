"""Weights for the port's models: the bridge from the JAX parameter trees and
optimizer state, reference checkpoint files, and a seeded numpy init.

The port's ``state_dict`` uses the reference PyTorch key names, the ones
``stereoformer_tpu/train/torch_import.py`` reads: ``lowcnn_state_dict_from_jax``
is the inverse of its ``convert_lowcnn_state_dict``, and
``raft_state_dict_from_jax`` of its ``convert_raft_state_dict``.
``cross_attention_state_dict_from_jax`` maps the one model without a
reference checkpoint; ``state_dict_from_jax`` picks the map by registry
name.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .train.optim import AmsgradState

# the backbone's ResBlocks in the order the JAX models create them; Flax
# numbers them ResBlock_0 ... ResBlock_4 in that order
_BACKBONE = ("conv2", "conv3", "downsample1", "downsample2", "downsample3")
# duplicate keys of reference checkpoints: Sequential aliases of LowCNN's
# conv_z/b/g, and of each RAFT residual block's norm3 (``downsample.1``)
_ALIASES = ("local_cost_volume.gru.conv_zz.0.", "local_cost_volume.gru.conv_bb.0.",
            "local_cost_volume.gru.conv_gg.0.")
_RAFT_ALIAS = ".downsample.1."


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _conv(sd, key, node, bias=True):
    """A Flax conv of any rank: kernel [k..., C_in, C_out] -> [C_out, C_in,
    k...]."""
    k = np.asarray(node["kernel"])
    n = k.ndim - 2
    sd[key + ".weight"] = _tensor(np.transpose(k, (n + 1, n, *range(n))))
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


def _numbered(tree, kind: str, count: int) -> list:
    """The top-level keys of ``tree`` that Flax gave the unnamed modules of
    type ``kind`` (``kind_0``, ``kind_1``, ...), in their number's order;
    raises unless there are ``count`` of them."""
    found = sorted((int(m.group(1)), k) for k in tree
                   if (m := re.fullmatch(rf"{kind}_(\d+)", k)))
    if len(found) != count:
        raise KeyError(f"expected {count} {kind}_N modules, found "
                       f"{[k for _, k in found]}")
    return [k for _, k in found]


def _backbone(sd, p, s):
    """The siamese backbone and FPN that the LowCNN family and
    CrossAttentionStereo share, from the modules Flax numbered."""
    (stem,) = _numbered(p, "ConvLReLU", 1)
    _conv(sd, "conv1.0", p[stem]["Conv_0"])
    for key, name in zip(_BACKBONE, _numbered(p, "ResBlock", len(_BACKBONE))):
        _resblock(sd, key, p[name], _at(s, name))
    (fpn,) = _numbered(p, "FPNFusion", 1)
    for i in range(2):
        node = p[fpn][f"ConvBnRelu_{i}"]
        _conv(sd, f"feature_concated.layer_list.{i}.conv", node["Conv_0"],
              bias=False)
        _bn(sd, f"feature_concated.layer_list.{i}.bn", node["BatchNorm_0"],
            _at(s, fpn, f"ConvBnRelu_{i}", "BatchNorm_0"))


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
    _backbone(sd, p, s)
    for i in range(3):
        _resblock(sd, f"correlation_aggreagtion.{i}", p[f"agg{i}"],
                  _at(s, f"agg{i}"))
    for name in ("concat_proj1", "concat_proj2"):
        if name in p:
            _dense(sd, name, p[name])

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


def cross_attention_state_dict_from_jax(variables) -> dict:
    """The JAX ``CrossAttentionStereo`` variables ``{"params",
    "batch_stats"}`` (numpy leaves) -> the port's ``state_dict``. Without
    ``"batch_stats"``, the parameters' entries only.

    Flax numbers this model's unnamed modules (``ConvLReLU_0``,
    ``ResBlock_0..4``, ``FPNFusion_0``, ``GRUUpdate_0``): they are found by
    kind and number. The backbone maps as LowCNN's, ``GRUUpdate_0`` as
    LowCNN's ``gru_update`` (to ``local_cost_volume``), ``agg{i}`` to
    ``agg.{i}``, and ``proj_q``, ``proj_k``, ``proj_v``, ``fuse1``,
    ``fuse2`` keep their names."""
    p, s = variables["params"], variables.get("batch_stats")
    sd: dict = {}
    _backbone(sd, p, s)
    for name in ("proj_q", "proj_k", "proj_v", "fuse1", "fuse2"):
        _conv(sd, name, p[name])
    for i in range(3):
        _resblock(sd, f"agg.{i}", p[f"agg{i}"], _at(s, f"agg{i}"))
    (gru,) = _numbered(p, "GRUUpdate", 1)
    _gru_head(sd, p[gru], _at(s, gru))
    return sd


def state_dict_from_jax(name: str, variables) -> dict:
    """The JAX variables of registry model ``name`` (numpy leaves) -> the
    port's ``state_dict``, for every name of the registry."""
    from .models.registry import available_models  # models import this module

    if name not in available_models():
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{available_models()}")
    if name == "RAFT_Stereo":
        return raft_state_dict_from_jax(variables)
    if name == "CrossAttentionStereo":
        return cross_attention_state_dict_from_jax(variables)
    return lowcnn_state_dict_from_jax(variables)


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
    gru = "local_cost_volume.gru."
    _split_zr(sd, gru + "conv_z", gru + "conv_b", g["ConvGRU_0"]["conv_zb"])
    _conv(sd, "local_cost_volume.gru.conv_g", g["ConvGRU_0"]["conv_g"])
    _conv(sd, "local_cost_volume.offset.conv1", g["OffsetHead_0"]["Conv_0"])
    _conv(sd, "local_cost_volume.offset.conv2", g["OffsetHead_0"]["Conv_1"])
    _conv(sd, "local_cost_volume.mask.0", g["mask_conv1"])
    _conv(sd, "local_cost_volume.mask.2", g["mask_conv2"])


def _deform_conv(sd, key, node):
    """DeformConv: ``offset_mask`` -> ``conv_offset_mask``, and its weight
    and bias."""
    _conv(sd, key + ".conv_offset_mask", node["offset_mask"])
    _deform_weight(sd, key + ".", node,
                   np.shape(node["offset_mask"]["kernel"])[0])


def _deform_weight(sd, key, node, k):
    """A deformable conv's weight [K*C, Co], tap-major (ky, kx, cin), ->
    [Co, C, k, k], and its bias where it has one."""
    w = np.asarray(node["weight"])
    C = w.shape[0] // (k * k)
    sd[key + "weight"] = _tensor(
        np.transpose(w.reshape(k, k, C, w.shape[1]), (3, 2, 0, 1)))
    if "bias" in node:
        sd[key + "bias"] = _tensor(node["bias"])


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
    leaves) of any option set -> the port's ``state_dict``. Without
    ``"batch_stats"``, the parameters' entries only.

    Kernels map HWIO -> OIHW; each GRU's fused gate conv ``convzr`` splits
    into ``convz`` (first half of its outputs) and ``convr``. What the
    option set builds is read from the tree: the context net's
    ``down{lvl}`` stages (``layer{3 + lvl}``) and output heads, the GRUs
    and the ``context_zqr`` convs of 1-3 levels; the mask head's width
    comes with its kernel."""
    p, s = variables["params"], variables.get("batch_stats")
    sd: dict = {}
    fnet = p["fnet"]
    _conv(sd, "fnet.conv1", fnet["Conv_0"])
    for n in (1, 2, 3):
        for i, half in enumerate("ab"):
            _raft_block(sd, f"fnet.layer{n}.{i}", fnet[f"layer{n}{half}"],
                        None, "downsample" in fnet[f"layer{n}{half}"],
                        bn=False)
    _conv(sd, "fnet.conv2", fnet["Conv_1"])

    cnet, cs = p["cnet"], _at(s, "cnet")
    _conv(sd, "cnet.conv1", cnet["Conv_0"])
    _bn(sd, "cnet.norm1", cnet["_Norm_0"]["BatchNorm_0"],
        _at(cs, "_Norm_0", "BatchNorm_0"))
    stages = [(1, "layer1"), (2, "layer2"), (3, "layer3")]
    levels = 1 + sum(f"down{lvl}a" in cnet for lvl in (1, 2))
    stages += [(3 + lvl, f"down{lvl}") for lvl in range(1, levels)]
    for n, ours in stages:
        for i, half in enumerate("ab"):
            node = cnet[f"{ours}{half}"]
            _raft_block(sd, f"cnet.layer{n}.{i}", node,
                        _at(cs, f"{ours}{half}"), "downsample" in node,
                        bn=True)
    for lvl, scale in zip(range(levels), ("08", "16", "32")):
        for h in range(2):
            conv = cnet[f"out{lvl}_{h}_conv"]
            if lvl == 2:
                _conv(sd, f"cnet.outputs32.{h}", conv)
                continue
            _raft_block(sd, f"cnet.outputs{scale}.{h}.0",
                        cnet[f"out{lvl}_{h}_res"],
                        _at(cs, f"out{lvl}_{h}_res"), shortcut=False, bn=True)
            _conv(sd, f"cnet.outputs{scale}.{h}.1", conv)

    ub = p["update_block"]
    for i, name in enumerate(("convc1", "convc2", "convf1", "convf2", "conv")):
        _conv(sd, f"update_block.encoder.{name}", ub["encoder"][f"Conv_{i}"])
    for g in ("gru08", "gru16", "gru32")[:levels]:
        key = f"update_block.{g}."
        _split_zr(sd, key + "convz", key + "convr", ub[g]["convzr"])
        _conv(sd, key + "convq", ub[g]["convq"])
    _conv(sd, "update_block.flow_head.conv1", ub["flow_head"]["Conv_0"])
    _conv(sd, "update_block.flow_head.conv2", ub["flow_head"]["Conv_1"])
    _conv(sd, "update_block.mask.0", ub["mask_conv1"])
    _conv(sd, "update_block.mask.2", ub["mask_conv2"])
    for i in range(levels):
        _conv(sd, f"context_zqr_convs.{i}", p[f"context_zqr{i}"])
    return sd


def _raft_norm(sd, key, node, stats):
    """A JAX ``_Norm``: its batch norm (``BatchNorm_0``) or group norm
    (``GroupNorm_0``, scale and shift); an instance norm has nothing."""
    if "BatchNorm_0" in node:
        _bn(sd, key, node["BatchNorm_0"], _at(stats, "BatchNorm_0"))
    elif "GroupNorm_0" in node:
        sd[key + ".weight"] = _tensor(node["GroupNorm_0"]["scale"])
        sd[key + ".bias"] = _tensor(node["GroupNorm_0"]["bias"])


def _sub(variables, name) -> dict:
    """The variables of submodule ``name``."""
    out = {"params": variables["params"][name]}
    stats = variables.get("batch_stats")
    if stats and name in stats:
        out["batch_stats"] = stats[name]
    return out


def _conv_transpose(sd, key, node):
    """Flax's ``ConvTranspose`` kernel [k..., C_in, C_out] (a plain conv of
    the dilated input) -> ``nn.conv.ConvTransposeSame``'s [C_in, C_out,
    k...], flipped along each spatial axis."""
    k = np.asarray(node["kernel"])
    n = k.ndim - 2
    k = np.flip(k, tuple(range(n)))
    sd[key + ".weight"] = _tensor(np.transpose(k, (n, n + 1, *range(n))))


def _dense(sd, key, node):
    sd[key + ".weight"] = _tensor(np.transpose(node["kernel"]))
    sd[key + ".bias"] = _tensor(node["bias"])


def _split_zr(sd, z, r, node):
    """A fused z/r gate conv -> its z (first half of the outputs) and r
    convs."""
    hidden = np.shape(node["bias"])[0] // 2
    for key, cut in ((z, slice(0, hidden)), (r, slice(hidden, None))):
        _conv(sd, key, {"kernel": np.asarray(node["kernel"])[..., cut],
                        "bias": np.asarray(node["bias"])[cut]})


def module_state_dict_from_jax(module: torch.nn.Module, variables) -> dict:
    """The Flax variables ``{"params", "batch_stats"}`` (numpy leaves) of
    the JAX counterpart of ``module`` -> ``module``'s ``state_dict``, for
    the modules no registry model holds: ``nn.deform``'s six,
    ``SepConvGRU``, ``ConvBn3D``, ``Hourglass3D``, ``SAModule``,
    ``ResSubmoduleAttention`` and RAFT's ``BottleneckBlock`` (``Conv_0``-
    ``Conv_2`` to ``conv1``-``conv3``, ``_Norm_0``-``_Norm_3`` to
    ``norm1``-``norm4``, ``downsample`` to ``downsample.0``)."""
    from .nn import aggregation, deform, gru, residual
    from .nn.raft import BottleneckBlock

    p, s = variables["params"], variables.get("batch_stats")
    sd: dict = {}
    if isinstance(module, deform.DeformRoIPooling):
        if isinstance(module, deform.DeformRoIPoolingPack):
            for key, name in (("0", "Dense_0"), ("2", "Dense_1"),
                              ("4", "offset_mask_fc")):
                _dense(sd, "offset_mask_fc." + key, p[name])
    elif isinstance(module, deform.ModulatedDeformConv):
        k = module.kernel_size
        _deform_weight(sd, "", p["deform"] if "deform" in p else p, k)
        for ours, theirs in (("conv_offset_mask", "offset_mask"),
                             ("conv_offset", "conv_offset")):
            if theirs in p:
                _conv(sd, ours, p[theirs])
    elif isinstance(module, gru.SepConvGRU):
        for d in "12":
            _split_zr(sd, "convz" + d, "convr" + d, p["convzr" + d])
            _conv(sd, "convq" + d, p["convq" + d])
    elif isinstance(module, aggregation.ConvBn3D):
        _conv(sd, "conv", p["Conv_0"], bias=False)
        _bn(sd, "bn", p["BatchNorm_0"], _at(s, "BatchNorm_0"))
    elif isinstance(module, aggregation.Hourglass3D):
        for i in range(4):
            sd.update({f"conv{i + 1}.{k}": v for k, v in
                       module_state_dict_from_jax(
                           module.conv1, _sub(variables, f"ConvBn3D_{i}")
                       ).items()})
        for i, key in enumerate(("conv5", "conv6")):
            _conv_transpose(sd, key + ".0", p[f"ConvTranspose_{i}"])
            _bn(sd, key + ".1", p[f"BatchNorm_{i}"],
                _at(s, f"BatchNorm_{i}"))
    elif isinstance(module, residual.SAModule):
        for i in range(3):
            _conv(sd, f"conv{i + 1}", p[f"Conv_{i}"], bias=False)
        for i in range(2):
            _bn(sd, f"bn{i + 1}", p[f"BatchNorm_{i}"],
                _at(s, f"BatchNorm_{i}"))
    elif isinstance(module, residual.ResSubmoduleAttention):
        sd.update({"attention." + k: v for k, v in module_state_dict_from_jax(
            module.attention, _sub(variables, "SAModule_0")).items()})
        # Flax numbers the plain convs in call order: conv1-3, conv4 unless
        # it is deformable, then the skips and the output conv
        convs = ["conv1.0", "conv2.0", "conv3.0"]
        if module.deform:
            _deform_conv(sd, "conv4.0", p["DeformConv_0"])
        else:
            convs.append("conv4.0")
        convs += ["redir2", "redir1", "res"]
        for i, key in enumerate(convs):
            _conv(sd, key, p[f"Conv_{i}"], bias=False)
        for i in range(6):
            _bn(sd, f"conv{i + 1}.1", p[f"BatchNorm_{i}"],
                _at(s, f"BatchNorm_{i}"))
        for i, key in enumerate(("conv5.0", "conv6.0")):
            _conv_transpose(sd, key, p[f"ConvTranspose_{i}"])
    elif isinstance(module, BottleneckBlock):
        for i in range(3):
            _conv(sd, f"conv{i + 1}", p[f"Conv_{i}"])
        if "downsample" in p:
            _conv(sd, "downsample.0", p["downsample"])
        for i in range(4):
            _raft_norm(sd, f"norm{i + 1}", p.get(f"_Norm_{i}", {}),
                       (s or {}).get(f"_Norm_{i}"))
    else:
        raise TypeError(f"no JAX counterpart known for "
                        f"{type(module).__name__}")
    return sd


def amsgrad_state_from_jax(opt_state, model: torch.nn.Module) -> AmsgradState:
    """optax's AMSGrad state for the JAX model of any registry name
    (``optax.amsgrad``'s chain state, or any tuple nesting that holds its
    ``ScaleByAmsgradState``) -> the port's ``AmsgradState`` for ``model``,
    on the model's device. ``mu``, ``nu`` and ``nu_max`` map as the
    parameters do (``raft_state_dict_from_jax`` for a ``RAFTStereo``,
    ``cross_attention_state_dict_from_jax`` for a ``CrossAttentionStereo``,
    else ``lowcnn_state_dict_from_jax``), so a JAX run goes on in the
    port."""
    # models import this module
    from .models.cross_attention import CrossAttentionStereo
    from .models.raft_stereo import RAFTStereo

    state = _find_amsgrad(opt_state)
    if state is None:
        raise ValueError("no AMSGrad state (with nu_max) in opt_state")
    params = dict(model.named_parameters())
    to_state_dict = (
        raft_state_dict_from_jax if isinstance(model, RAFTStereo)
        else cross_attention_state_dict_from_jax
        if isinstance(model, CrossAttentionStereo)
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
    """The model weights of a port checkpoint (``train.save_checkpoint``'s
    ``"model"``) or of a port or reference ``.pth`` state_dict, read with
    ``torch.load(weights_only=True)``: unwraps ``{"model": ...}`` and
    ``{"state_dict": ...}``, strips DataParallel's ``module.`` prefix and
    drops the reference's duplicate alias keys (LowCNN's GRU convs, RAFT's
    ``downsample.1`` norms)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = next((raw[k] for k in ("model", "state_dict")
               if isinstance(raw.get(k), dict)), raw)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if not k.startswith(_ALIASES) and _RAFT_ALIAS not in k}


def seeded_state_dict(model: torch.nn.Module, seed: int = 0,
                      fan: str = "fan_in") -> dict:
    """Random weights for ``model`` from numpy, made from ``seed``: each
    weight of two or more axes (a conv's of any rank, a deformable conv's,
    a linear layer's) plain normal, he-scaled over its ``fan`` ("fan_in",
    as LowCNN's init, or "fan_out", as RAFT's: axis 1 or 0 of the weight
    times its window), biases zero, BatchNorm the identity (scale 1, shift
    0, mean 0, variance 1), an offset predictor (``conv_offset_mask``,
    ``conv_offset``) zero (so a ``DeformConv`` starts as a plain conv
    modulated by 0.5). It is the registry's init, and the tests' and
    ``chip_smoke.py``'s, whose values depend on it; the trainer starts
    from ``init_state_dict``, the JAX models' distributions."""
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
    for each weight of two or more axes, in module order; see
    ``seeded_state_dict`` for the rest."""
    sd = {}
    for name, m in model.named_modules():
        key = name + "." if name else ""
        own = dict(m.named_parameters(recurse=False))
        if name.endswith(("conv_offset_mask", "conv_offset")):
            sd[key + "weight"] = torch.zeros(m.weight.shape)
            sd[key + "bias"] = torch.zeros(m.out_channels)
        elif isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            sd[key + "weight"] = torch.ones(n)
            sd[key + "bias"] = torch.zeros(n)
            sd[key + "running_mean"] = torch.zeros(n)
            sd[key + "running_var"] = torch.ones(n)
            sd[key + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif "weight" in own and own["weight"].dim() >= 2:
            shape = tuple(own["weight"].shape)
            fans = {"fan_in": shape[1], "fan_out": shape[0]}
            sd[key + "weight"] = _tensor(weight(name, shape, fans))
            if own.get("bias") is not None:
                sd[key + "bias"] = torch.zeros(own["bias"].shape)
    return sd
