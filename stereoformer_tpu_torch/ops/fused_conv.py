"""Fused stride-1 3x3 SAME convolution (NHWC, HWIO weights).

Counterpart of the Pallas kernel ``stereoformer_tpu/ops/pallas/conv2d.py``
(``_forward``) and its four entry points, with the same arguments and
layouts:

    conv2d_fused(x, w, b, residual=None, relu=True)
    conv2d_fused_prologue(x, w, b, s, t, relu=False)
    conv2d_fused_stats(x, w, b, relu=False)              -> (y, S1, S2)
    conv2d_fused_prologue_stats(x, w, b, s, t, relu=False) -> (y, S1, S2)

    y = relu?(conv3x3_SAME(pro(x), w) + b + residual?),
    pro(x) = relu(x * s[b, c] + t[b, c]) with the prologue, else x;
    S1[b, co] = sum_{h, w} y, S2[b, co] = sum_{h, w} y^2.

x [B, H, W, C], w [3, 3, C, Co], b [Co], s and t [B, C], residual
[B, H, W, Co]. The padding is zero whatever the prologue. CPU tensors take
the plain version (``conv3x3_plain``); CUDA tensors launch the kernel
``csrc/conv2d_fused.cu`` or raise, counting launches in
``conv2d_fused.launches`` (one count for all four entry points: they are one
kernel). The kernel has no backward yet: on CUDA tensors the gradient raises
until the RAFT training slice ports ``_bwd`` and ``_prologue_bwd``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

# the kernel's output tile (csrc/conv2d_fused.cu: TH, TW); one moment
# partial per tile
_TILE_H, _TILE_W = 8, 32
# the output widths RAFT routes to the kernel (one template each)
_KERNEL_CO = (64, 96)


def conv3x3_plain(x, w, b, residual=None, relu=False, s=None, t=None,
                  with_stats=False):
    """The plain version of every entry point (same arguments); the moments
    are summed in float64 and returned as float32."""
    if s is not None:
        x = torch.relu(x * s[:, None, None, :] + t[:, None, None, :])
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                 padding=(w.shape[0] // 2, w.shape[1] // 2)).permute(0, 2, 3, 1)
    if residual is not None:
        y = y + residual
    if relu:
        y = torch.relu(y)
    if not with_stats:
        return y
    y64 = y.double()
    return (y, y64.sum((1, 2)).float(), y64.square().sum((1, 2)).float())


class _FusedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, residual, s, t, relu, with_stats):
        given = [a for a in (x, w, b, residual, s, t) if a is not None]
        kernels.check_inputs("conv2d_fused", *given)
        if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3):
            raise ValueError(
                f"conv2d_fused: the kernel takes x [B, H, W, C] and w "
                f"[3, 3, C, Co], got {tuple(x.shape)} and {tuple(w.shape)}")
        B, H, W, C = x.shape
        Co = w.shape[3]
        if w.shape[2] != C or C % 8 or Co not in _KERNEL_CO:
            raise ValueError(
                f"conv2d_fused: the kernel takes C a multiple of 8 and Co in "
                f"{_KERNEL_CO}, got w {tuple(w.shape)} for C={C}")
        if b.shape != (Co,):
            raise ValueError(f"conv2d_fused: b must be [{Co}]")
        if residual is not None and residual.shape != (B, H, W, Co):
            raise ValueError(f"conv2d_fused: residual must be {(B, H, W, Co)}")
        if s is not None and (s.shape != (B, C) or t.shape != (B, C)):
            raise ValueError(f"conv2d_fused: s and t must be [{B}, {C}]")
        y = x.new_empty((B, H, W, Co))
        part = s1 = s2 = None
        if with_stats:
            tiles = -(-H // _TILE_H) * -(-W // _TILE_W)
            part = x.new_empty((B, tiles, 2, Co))
            s1, s2 = x.new_empty((B, Co)), x.new_empty((B, Co))

        def ptr(a):
            return None if a is None else a.data_ptr()

        kernels.launch("conv2d_fused", x.device, x.data_ptr(), w.data_ptr(),
                       b.data_ptr(), ptr(s), ptr(t), ptr(residual),
                       y.data_ptr(), ptr(part), ptr(s1), ptr(s2), B, H, W, C,
                       Co, int(relu))
        conv2d_fused.launches += 1
        return (y, s1, s2) if with_stats else y

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "conv2d_fused: the backward of the fused conv kernel (the Pallas "
            "_bwd and _prologue_bwd) is not ported yet; it comes with the "
            "RAFT training slice")


def conv3x3_fused(x, w, b, residual=None, relu=False, s=None, t=None,
                  with_stats=False):
    """Every entry point in one call, with ``conv3x3_plain``'s arguments:
    the plain version on CPU tensors, the kernel on CUDA tensors."""
    if all(a.device.type == "cpu" for a in (x, w, b)):
        return conv3x3_plain(x, w, b, residual, relu, s, t, with_stats)
    return _FusedConv.apply(x, w, b, residual, s, t, relu, with_stats)


def conv2d_fused(x, w, b, residual=None, relu: bool = True):
    """y = relu?(conv3x3_SAME(x, w) + b + residual?)."""
    return conv3x3_fused(x, w, b, residual, relu)


def conv2d_fused_prologue(x, w, b, s, t, relu: bool = False):
    """y = relu?(conv3x3_SAME(relu(x * s + t), w) + b), s and t [B, C]."""
    return conv3x3_fused(x, w, b, None, relu, s, t)


def conv2d_fused_stats(x, w, b, relu: bool = False):
    """``conv2d_fused`` without residual, and the output's per-sample
    channel moments: -> (y, S1, S2), S1 and S2 [B, Co] float32."""
    return conv3x3_fused(x, w, b, None, relu, with_stats=True)


def conv2d_fused_prologue_stats(x, w, b, s, t, relu: bool = False):
    """``conv2d_fused_prologue`` and the output's moments (y, S1, S2)."""
    return conv3x3_fused(x, w, b, None, relu, s, t, True)


conv2d_fused.launches = 0
