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
"""

from __future__ import annotations

import torch
from torch import nn

from ..blocks import FusedConv
from ..norm import BatchNorm2d


class GroupNorm(nn.Module):
    """Group norm with the JAX package's numbers: eps 1e-6, variance
    max(E[x^2] - E[x]^2, 0) from per-channel sums over H and W merged within
    each group. ``num_groups == num_channels`` without affine is the
    instance norm. ``forward(x, stats_only=False, precomputed_sums=None)``:
    with ``precomputed_sums=(S1, S2)`` [B, C] the sums over x are not taken
    again; with ``stats_only`` it returns the affine form (s, t) [B, C] with
    norm(x) = x*s + t instead of applying it."""

    def __init__(self, num_groups: int, num_channels: int,
                 affine: bool = True, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = self.bias = None
        if affine:
            self.weight = nn.Parameter(torch.ones(num_channels))
            self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, stats_only: bool = False, precomputed_sums=None):
        if precomputed_sums is None:
            s1, s2 = x.sum((2, 3)), x.square().sum((2, 3))
        else:
            s1, s2 = precomputed_sums
        n = x.shape[2] * x.shape[3]
        B, C = s1.shape
        G = self.num_groups
        m1 = (s1 / n).reshape(B, G, C // G).mean(-1)
        m2 = (s2 / n).reshape(B, G, C // G).mean(-1)
        inv = torch.rsqrt((m2 - m1.square()).clamp(min=0.0) + self.eps)
        mean_c = m1.repeat_interleave(C // G, dim=1)
        inv_c = inv.repeat_interleave(C // G, dim=1)
        if self.weight is not None:
            inv_c = inv_c * self.weight
        if stats_only:
            t = -mean_c * inv_c
            return inv_c, t if self.bias is None else t + self.bias
        y = (x - mean_c[:, :, None, None]) * inv_c[:, :, None, None]
        return y if self.bias is None else y + self.bias[:, None, None]


def make_norm(kind: str, channels: int) -> nn.Module:
    """The reference's norm of ``kind``: "batch" (Flax's BatchNorm, eps
    1e-5) or "instance" (no parameters)."""
    if kind == "batch":
        return BatchNorm2d(channels)
    if kind == "instance":
        return GroupNorm(channels, channels, affine=False)
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


class RaftResidualBlock(nn.Module):
    """conv-norm-ReLU-conv-norm-ReLU, plus a 1x1 conv-norm shortcut when the
    stride or width changes, then ReLU of the sum. Keys ``conv1``, ``conv2``,
    ``norm1``, ``norm2``, and ``downsample.0`` with ``norm3``."""

    def __init__(self, in_planes: int, planes: int, norm: str = "group",
                 stride: int = 1):
        super().__init__()
        self.conv1 = (FusedConv(in_planes, planes) if stride == 1 else
                      nn.Conv2d(in_planes, planes, 3, stride=stride,
                                padding=1))
        self.conv2 = FusedConv(planes, planes)
        self.norm1 = make_norm(norm, planes)
        self.norm2 = make_norm(norm, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride))
            self.norm3 = make_norm(norm, planes)

    def forward(self, x):
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


def _layers(norm: str) -> list:
    """layer1-3, shared by both encoders: full resolution, then 1/2 and
    1/4."""
    mods, cin = [], 64
    for dim, stride in ((64, 1), (96, 2), (128, 2)):
        mods.append(nn.Sequential(RaftResidualBlock(cin, dim, norm, stride),
                                  RaftResidualBlock(dim, dim, norm, 1)))
        cin = dim
    return mods


class BasicEncoder(nn.Module):
    """Feature net, instance norm: [B, 3, H, W] -> [B, 256, H/4, W/4]."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, padding=3)
        self.norm1 = make_norm("instance", 64)
        self.layer1, self.layer2, self.layer3 = _layers("instance")
        self.conv2 = nn.Conv2d(128, 256, 1)

    def forward(self, x):
        x = torch.relu(apply_norm(self.norm1, self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class MultiBasicEncoder(nn.Module):
    """Context net, batch norm: two 128-channel heads (hidden state and
    context) at 1/4, 1/8 and 1/16, finest first. Keys ``layer4``/``layer5``
    (the coarser levels), ``outputs08``/``outputs16`` (a residual block and
    a conv per head) and ``outputs32`` (a conv per head)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, padding=3)
        self.norm1 = make_norm("batch", 64)
        self.layer1, self.layer2, self.layer3 = _layers("batch")
        self.layer4, self.layer5 = (
            nn.Sequential(RaftResidualBlock(128, 128, "batch", 2),
                          RaftResidualBlock(128, 128, "batch", 1))
            for _ in range(2))
        self.outputs08, self.outputs16 = (
            nn.ModuleList(nn.Sequential(
                RaftResidualBlock(128, 128, "batch", 1), FusedConv(128, 128))
                for _ in range(2))
            for _ in range(2))
        self.outputs32 = nn.ModuleList(FusedConv(128, 128) for _ in range(2))

    def forward(self, x):
        x = torch.relu(apply_norm(self.norm1, self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        feats = [x, self.layer4(x)]
        feats.append(self.layer5(feats[-1]))
        heads = (self.outputs08, self.outputs16, self.outputs32)
        return [tuple(head(f) for head in level)
                for f, level in zip(feats, heads)]
