"""RAFT-Stereo's multi-scale GRU update cascade (NCHW modules).

Counterparts of ``stereoformer_tpu/nn/raft/update.py`` (``pool2x``,
``interp_to``, ``FlowHead``, ``ContextConvGRU``, ``BasicMotionEncoder``,
``MultiUpdateBlock``). Submodule names follow the reference ``state_dict``
keys: the JAX package fuses each GRU's z and r gate convs into ``convzr``;
here they are the reference's ``convz`` and ``convr``.

``dtype=torch.bfloat16``, as the JAX block: the GRUs (their hidden states,
gates and context biases) and the motion encoder compute in bf16, the flow
among the motion features rounded to bf16 too; the flow head's last conv
and the mask head's ``mask.2`` compute in float32 (they feed coordinates
and a softmax), so the block returns a float32 flow update and mask.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize_bilinear
from .. import bf16
from ..conv import Conv2d

# RAFT-Stereo's widths: a 128-channel hidden state at each of the 3 GRU
# levels, a correlation pyramid of 4 levels read at radius 4, and features
# at 1/4 of the input, upsampled 4x
HIDDEN = 128
CORR_LEVELS = 4
CORR_RADIUS = 4
FACTOR = 4


def pool2x(x):
    """3x3 stride-2 average pool, padding 1, the padding counted. A bf16 x
    is pooled as XLA pools it: the window summed in bf16, each add
    rounded, row by row, then multiplied by the float32 1/9 and rounded."""
    if x.dtype != torch.bfloat16:
        return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)
    Ho, Wo = (x.shape[2] - 1) // 2 + 1, (x.shape[3] - 1) // 2 + 1
    xp = F.pad(x, (1, 1, 1, 1))
    acc = torch.zeros_like(xp[:, :, :Ho, :Wo])
    for ky in range(3):
        for kx in range(3):
            acc = acc + xp[:, :, ky:ky + 2 * Ho - 1:2, kx:kx + 2 * Wo - 1:2]
    return acc * (1.0 / 9.0)


def interp_to(x, ref):
    """Bilinear resize of x to ref's H and W, align_corners=True."""
    out = resize_bilinear(x.permute(0, 2, 3, 1), ref.shape[2:],
                          align_corners=True)
    return out.permute(0, 3, 1, 2)


def _conv3(cin, cout, dtype=None):
    return Conv2d(cin, cout, 3, padding=1, dtype=dtype)


class FlowHead(nn.Module):
    """conv-ReLU-conv -> the 2-channel flow update (the last conv float32)."""

    def __init__(self, dtype=None):
        super().__init__()
        self.conv1 = _conv3(HIDDEN, 256, dtype)
        self.conv2 = _conv3(256, 2, torch.float32)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class ContextConvGRU(nn.Module):
    """ConvGRU whose z, r and q gates each get a context bias (cz, cr, cq):
    z = sigmoid(convz([h, x]) + cz), r = sigmoid(convr([h, x]) + cr),
    q = tanh(convq([r*h, x]) + cq), h' = (1 - z)*h + z*q, with x the
    inputs concatenated."""

    def __init__(self, hidden_dim: int, input_dim: int, dtype=None):
        super().__init__()
        self.convz = _conv3(hidden_dim + input_dim, hidden_dim, dtype)
        self.convr = _conv3(hidden_dim + input_dim, hidden_dim, dtype)
        self.convq = _conv3(hidden_dim + input_dim, hidden_dim, dtype)

    def forward(self, h, context, *inputs):
        cz, cr, cq = context
        x = torch.cat([i.to(h.dtype) for i in inputs], dim=1)
        hx = torch.cat([h, x], dim=1)
        z = bf16.sigmoid(self.convz(hx) + cz)
        r = bf16.sigmoid(self.convr(hx) + cr)
        q = bf16.tanh(self.convq(torch.cat([r * h, x], dim=1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """corr [B, L(2r+1), H, W] and flow [B, 2, H, W] -> 128 channels, the
    last two of them the flow itself."""

    def __init__(self, dtype=None):
        super().__init__()
        self.convc1 = Conv2d(CORR_LEVELS * (2 * CORR_RADIUS + 1), 64, 1,
                             dtype=dtype)
        self.convc2 = _conv3(64, 64, dtype)
        self.convf1 = Conv2d(2, 64, 7, padding=3, dtype=dtype)
        self.convf2 = _conv3(64, 64, dtype)
        self.conv = _conv3(128, 128 - 2, dtype)

    def forward(self, flow, corr):
        c = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        f = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow.to(out.dtype)], dim=1)


class MultiUpdateBlock(nn.Module):
    """The 3-level GRU cascade, coarsest first: gru32 (1/16), gru16, then
    gru08 (1/4) with the motion features; the flow head and the 0.25-scaled
    convex-upsample mask head read the finest level. ``net`` and ``inp``
    are finest-first lists of ``HIDDEN``-channel maps."""

    def __init__(self, dtype=None):
        super().__init__()
        hd = HIDDEN
        self.encoder = BasicMotionEncoder(dtype)
        self.gru08 = ContextConvGRU(hd, 128 + hd, dtype)
        self.gru16 = ContextConvGRU(hd, 2 * hd, dtype)
        self.gru32 = ContextConvGRU(hd, hd, dtype)
        self.flow_head = FlowHead(dtype)
        self.mask = nn.Sequential(
            _conv3(hd, 256, dtype), nn.ReLU(),
            Conv2d(256, FACTOR * FACTOR * 9, 1, dtype=torch.float32))

    def forward(self, net, inp, corr, flow, need_mask: bool = True):
        """-> (net, mask [B, 9 f^2, H, W] or None, delta_flow [B, 2, H, W])."""
        net = list(net)
        net[2] = self.gru32(net[2], inp[2], pool2x(net[1]))
        net[1] = self.gru16(net[1], inp[1], pool2x(net[0]),
                            interp_to(net[2], net[1]))
        motion = self.encoder(flow, corr)
        net[0] = self.gru08(net[0], inp[0], motion, interp_to(net[1], net[0]))
        delta = self.flow_head(net[0])
        if not need_mask:
            return net, None, delta
        return net, 0.25 * self.mask(net[0]), delta
