"""RAFT-Stereo encoders (NCHW modules, train and eval).

Counterparts of ``stereoformer_tpu/nn/raft/encoders.py``: ``GroupNorm``
(``GroupNormNHWC``), the eval forms of ``_BNStats`` and ``_Norm``,
``RaftResidualBlock``, ``BasicEncoder`` (the feature net, instance norm) and
``MultiBasicEncoder`` (the context net, batch norm). Submodule names follow
the reference ``state_dict`` keys (``extractor.py``), which
``stereoformer_tpu/train/torch_import.py::convert_raft_state_dict`` reads.

Activations are ``channels_last``: the fused conv reads their NHWC view, so
no layout copy is made around it. A block's stride-1 3x3 convs are
``FusedConv``s, and its norm fuses into them as the JAX package's does: the
first conv emits its output's moments (sample-local norms), the norm turns
them (or, in eval, batch norm's running statistics) into a per-sample affine
(s, t), and the second conv applies relu(x*s + t) as it reads its input,
emitting its own output's moments for the second norm. Batch norm in train
mode takes the batch's statistics and is not fused: the second conv reads
relu(norm1(y)).

``dtype=torch.bfloat16`` is the JAX encoders' compute dtype: every conv
casts its input and kernel to bf16 (the routed 3x3 sites take the fused
conv's bf16 form), batch norm computes in float32 and casts its output,
and the group and instance norms take float32 statistics of the bf16
activation and then subtract and scale in bf16 arithmetic, as
``GroupNormNHWC._apply`` does with ``cd = out_dtype``. Where XLA reads a
conv's ``+ bias`` in float32 (a batch norm, a norm's moments, the
prologue's ``x.astype(float32)`` at a conv that is not routed, the feature
net's output read by the all-pairs product) the port reads
``Conv2d.forward_f32``; a routed conv's output is the kernel's, rounded
once, with its moments.
"""

from __future__ import annotations

import torch
from torch import nn

from ..blocks import FusedConv, prologue_fma
from ..conv import Conv2d
from ..norm import BatchNorm2d


class GroupNorm(nn.Module):
    """Group norm with the JAX package's numbers: eps 1e-6, variance
    max(E[x^2] - E[x]^2, 0) from per-channel sums over H and W merged within
    each group. ``num_groups == num_channels`` without affine is the
    instance norm. ``dtype`` is the output's: the statistics are float32
    sums of x whatever its dtype, and with ``dtype`` set the normalisation
    runs in that dtype's arithmetic. ``forward(x, stats_only=False, precomputed_sums=None)``:
    with ``precomputed_sums=(S1, S2)`` [B, C] the sums over x are not taken
    again; with ``stats_only`` it returns the affine form (s, t) [B, C] with
    norm(x) = x*s + t instead of applying it."""

    def __init__(self, num_groups: int, num_channels: int,
                 affine: bool = True, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.out_dtype = dtype
        self.weight = self.bias = None
        if affine:
            self.weight = nn.Parameter(torch.ones(num_channels))
            self.bias = nn.Parameter(torch.zeros(num_channels))

    @staticmethod
    def sums(x, x32=None):
        """The per-sample channel sums (S1, S2) [B, C] of x, in float32;
        S1 of ``x32`` where given: XLA sums a conv's ``+ bias`` unrounded
        and squares it rounded to bf16."""
        xf = x.float()
        return (xf if x32 is None else x32).sum((2, 3)), xf.square().sum((2, 3))

    def forward(self, x, stats_only: bool = False, precomputed_sums=None):
        s1, s2 = precomputed_sums or self.sums(x)
        n = x.shape[2] * x.shape[3]
        B, C = s1.shape
        G = self.num_groups
        if self.out_dtype is not None:
            # XLA multiplies by the float32 1/n where JAX divides
            s1, s2 = s1 * (1.0 / n), s2 * (1.0 / n)
        else:
            s1, s2 = s1 / n, s2 / n
        m1 = s1.reshape(B, G, C // G).mean(-1)
        m2 = s2.reshape(B, G, C // G).mean(-1)
        inv = torch.rsqrt((m2 - m1.square()).clamp(min=0.0) + self.eps)
        mean_c = m1.repeat_interleave(C // G, dim=1)
        inv_c = inv.repeat_interleave(C // G, dim=1)
        if self.weight is not None:
            inv_c = inv_c * self.weight
        if stats_only:
            t = -mean_c * inv_c
            return inv_c, t if self.bias is None else t + self.bias
        cd = self.out_dtype or torch.promote_types(x.dtype, inv_c.dtype)
        y = ((x.to(cd) - mean_c[:, :, None, None].to(cd))
             * inv_c[:, :, None, None].to(cd))
        return (y if self.bias is None
                else y + self.bias[:, None, None].to(cd))


def make_norm(kind: str, channels: int, dtype=None) -> nn.Module:
    """The reference's norm of ``kind``: "batch" (Flax's BatchNorm, eps
    1e-5) or "instance" (no parameters)."""
    if kind == "batch":
        return BatchNorm2d(channels, dtype=dtype)
    if kind == "instance":
        return GroupNorm(channels, channels, affine=False, dtype=dtype)
    raise ValueError(f"unknown norm {kind!r}")


def norm_affine(norm: nn.Module, x: torch.Tensor, sums=None):
    """The norm of x as a per-sample affine (s, t) [B, C] (JAX
    ``_Norm(stats_only=True)``): from the moments for a group or instance
    norm, from the running statistics for batch norm in eval (``_BNStats``);
    batch norm in train mode has no such form (JAX returns None) and
    raises."""
    if isinstance(norm, GroupNorm):
        return norm(x, stats_only=True, precomputed_sums=sums)
    if norm.training:
        raise ValueError("norm_affine: batch norm in train mode takes the "
                         "batch's statistics; it is not an affine")
    s = norm.weight * torch.rsqrt(norm.running_var + norm.eps)
    t = norm.bias - norm.running_mean * s
    B = x.shape[0]
    return s.expand(B, -1).contiguous(), t.expand(B, -1).contiguous()


def apply_norm(norm: nn.Module, x: torch.Tensor, sums=None):
    if isinstance(norm, GroupNorm):
        return norm(x, precomputed_sums=sums)
    return norm(x)


def norm_f32(norm: nn.Module, y32: torch.Tensor, dtype) -> torch.Tensor:
    """The norm of a conv's output given as XLA reads it in float32
    (``Conv2d.forward_f32``), in bf16 compute: batch norm normalises the
    float32 values; a group norm takes S1 from them, S2 from the output
    rounded to ``dtype``, and normalises the rounded output."""
    if isinstance(norm, GroupNorm):
        y = y32.to(dtype)
        return norm(y, precomputed_sums=GroupNorm.sums(y, y32))
    return norm(y32)


def _conv_f32(conv: nn.Module, x: torch.Tensor, prologue=None):
    """A conv that is not routed, in bf16 compute: its output as XLA reads
    it in float32 (``Conv2d.forward_f32``), the prologue relu(x*s + t)
    applied to x (float32 or bf16, x*s + t one FMA) and rounded to bf16
    first."""
    if prologue is not None:
        x = prologue_fma(x, *prologue).to(conv.compute_dtype)
    return conv.forward_f32(x)


class RaftResidualBlock(nn.Module):
    """conv-norm-ReLU-conv-norm-ReLU, plus a 1x1 conv-norm shortcut when the
    stride or width changes, then ReLU of the sum. Keys ``conv1``, ``conv2``,
    ``norm1``, ``norm2``, and ``downsample.0`` with ``norm3``."""

    def __init__(self, in_planes: int, planes: int, norm: str = "group",
                 stride: int = 1, dtype=None):
        super().__init__()
        self.conv1 = (FusedConv(in_planes, planes, dtype) if stride == 1 else
                      Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                             dtype=dtype))
        self.conv2 = FusedConv(planes, planes, dtype)
        self.norm1 = make_norm(norm, planes, dtype)
        self.norm2 = make_norm(norm, planes, dtype)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride, dtype=dtype))
            self.norm3 = make_norm(norm, planes, dtype)

    def forward(self, x):
        if self.conv2.compute_dtype is not None:
            return self._forward_lowp(x)
        # sample-local norms take their moments from the convs
        local = isinstance(self.norm1, GroupNorm)
        sums1 = sums2 = None
        if local and isinstance(self.conv1, FusedConv):
            y, sums1 = self.conv1(x, with_stats=True)
        else:
            y = self.conv1(x)
        if local:
            y, sums2 = self.conv2(y, prologue=norm_affine(self.norm1, y, sums1),
                                  with_stats=True)
        elif not self.norm1.training:
            y = self.conv2(y, prologue=norm_affine(self.norm1, y))
        else:
            y = self.conv2(torch.relu(self.norm1(y)))
        y = torch.relu(apply_norm(self.norm2, y, sums2))
        if self.downsample is not None:
            x = self.norm3(self.downsample(x))
        return torch.relu(x + y)

    def _forward_lowp(self, x):
        """The bf16 block, as the JAX block computes it: a routed conv is
        the kernel's bf16 form (rounded once, its moments of the rounded
        output); at a conv that is not routed, the norm (its moments, or
        batch norm's input) and the next conv's prologue read the conv's
        ``+ bias`` in float32, as XLA does."""
        dt = self.conv2.compute_dtype
        local = isinstance(self.norm1, GroupNorm)
        routed1 = isinstance(self.conv1, FusedConv) and self.conv1.routed
        if routed1:
            y1, sums1 = (self.conv1(x, with_stats=True) if local
                         else (self.conv1(x), None))
            y1_32 = y1
        else:
            y1_32 = _conv_f32(self.conv1, x)
            y1 = y1_32.to(dt)
            sums1 = GroupNorm.sums(y1, y1_32) if local else None
        if local or not self.norm1.training:
            pro = norm_affine(self.norm1, y1, sums1)
        else:
            pro = None
        if self.conv2.routed:
            z = y1 if pro is not None else torch.relu(self.norm1(y1_32))
            y2, sums2 = (self.conv2(z, prologue=pro, with_stats=True) if local
                         else (self.conv2(z, prologue=pro), None))
            y = apply_norm(self.norm2, y2, sums2)
        elif pro is not None:
            y = norm_f32(self.norm2, _conv_f32(self.conv2, y1_32, pro), dt)
        else:
            z = torch.relu(self.norm1(y1_32))
            y = norm_f32(self.norm2, _conv_f32(self.conv2, z), dt)
        y = torch.relu(y)
        if self.downsample is not None:
            x = norm_f32(self.norm3, _conv_f32(self.downsample[0], x), dt)
        return torch.relu(x + y)


def _layers(norm: str, dtype) -> list:
    """layer1-3, shared by both encoders: full resolution, then 1/2 and
    1/4."""
    mods, cin = [], 64
    for dim, stride in ((64, 1), (96, 2), (128, 2)):
        mods.append(nn.Sequential(
            RaftResidualBlock(cin, dim, norm, stride, dtype),
            RaftResidualBlock(dim, dim, norm, 1, dtype)))
        cin = dim
    return mods


class BasicEncoder(nn.Module):
    """Feature net, instance norm: [B, 3, H, W] -> [B, 256, H/4, W/4]."""

    def __init__(self, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, padding=3, dtype=dtype)
        self.norm1 = make_norm("instance", 64, dtype)
        self.layer1, self.layer2, self.layer3 = _layers("instance", dtype)
        self.conv2 = Conv2d(128, 256, 1, dtype=dtype)

    def forward(self, x):
        """-> the features, or in bf16 compute the float32 ``+ bias`` of
        the last conv, which the all-pairs product reads in float32."""
        dt = self.conv1.compute_dtype
        if dt is None:
            x = torch.relu(apply_norm(self.norm1, self.conv1(x)))
            x = self.layer3(self.layer2(self.layer1(x)))
            return self.conv2(x)
        x = torch.relu(norm_f32(self.norm1, _conv_f32(self.conv1, x), dt))
        x = self.layer3(self.layer2(self.layer1(x)))
        return _conv_f32(self.conv2, x)


class MultiBasicEncoder(nn.Module):
    """Context net, batch norm: two 128-channel heads (hidden state and
    context) at 1/4, 1/8 and 1/16, finest first. Keys ``layer4``/``layer5``
    (the coarser levels), ``outputs08``/``outputs16`` (a residual block and
    a conv per head) and ``outputs32`` (a conv per head)."""

    def __init__(self, dtype=None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, padding=3, dtype=dtype)
        self.norm1 = make_norm("batch", 64, dtype)
        self.layer1, self.layer2, self.layer3 = _layers("batch", dtype)
        self.layer4, self.layer5 = (
            nn.Sequential(RaftResidualBlock(128, 128, "batch", 2, dtype),
                          RaftResidualBlock(128, 128, "batch", 1, dtype))
            for _ in range(2))
        self.outputs08, self.outputs16 = (
            nn.ModuleList(nn.Sequential(
                RaftResidualBlock(128, 128, "batch", 1, dtype),
                FusedConv(128, 128, dtype))
                for _ in range(2))
            for _ in range(2))
        self.outputs32 = nn.ModuleList(FusedConv(128, 128, dtype)
                                       for _ in range(2))

    def forward(self, x):
        dt = self.conv1.compute_dtype
        if dt is None:
            x = torch.relu(apply_norm(self.norm1, self.conv1(x)))
        else:
            x = torch.relu(norm_f32(self.norm1, _conv_f32(self.conv1, x), dt))
        x = self.layer3(self.layer2(self.layer1(x)))
        feats = [x, self.layer4(x)]
        feats.append(self.layer5(feats[-1]))
        heads = (self.outputs08, self.outputs16, self.outputs32)
        return [tuple(head(f) for head in level)
                for f, level in zip(feats, heads)]
