"""``Conv``: the JAX package's ``nn/conv.py::Conv`` forward as ``nn.Conv2d``;
``ConvTransposeSame``: Flax's ``ConvTranspose(padding="SAME")``.

The JAX modules of this slice pad every convolution symmetrically by
(k - 1) // 2, which is what ``nn.Conv2d`` does with an integer padding.

The compute dtype is Flax's: the parameters stay float32 and are cast at
the op. With ``dtype=torch.bfloat16`` x and the kernel are cast to bf16,
the convolution's result is rounded to bf16, and ``+ bias`` (the bias cast
to bf16) is rounded again, as ``lax.conv_general_dilated(x, k) +
bias.astype(dt)`` rounds in JAX. With ``dtype=None`` the compute dtype is
the promotion of x's and the kernel's (float32 for the port's float32
parameters), as ``jnp.result_type(x, kernel)``.

Where the JAX module casts a bf16 op's result to float32 right away (a
BatchNorm's ``x - mean``, an ``.astype(float32)``), XLA computes that op in
float32 and never rounds it to bf16: ``conv + bias`` is the conv rounded to
bf16 plus the bias in float32, a conv without bias is the float32 conv.
``Conv2d.forward_f32`` gives that value. The value is still a bf16 array to
JAX's autodiff, so its cotangent is rounded to bf16 before it reaches the
conv and the bias: ``forward_f32`` rounds it there too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# the compute dtypes the port serves: Flax's None (float32) and bf16
DTYPES = (None, torch.float32, torch.bfloat16)


def check_dtype(dtype):
    """``dtype`` as the port's modules keep it: None for float32 (the
    default), or torch.bfloat16; any other raises, naming it."""
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"dtype={dtype!r} is not ported; the port computes in float32 "
            f"(None) or torch.bfloat16")
    return None if dtype == torch.float32 else dtype


def compute_dtype(dtype, x: torch.Tensor) -> torch.dtype:
    """Flax's ``self.dtype or jnp.result_type(x, kernel)`` for float32
    parameters."""
    return dtype or torch.promote_types(x.dtype, torch.float32)


class _Bf16Cotangent(torch.autograd.Function):
    """The identity on a float32 value that JAX holds as bf16: its
    cotangent is rounded to bf16 (and widened back), as JAX's is."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with the JAX ``Conv``'s compute dtype (``dtype``); its
    parameters and ``state_dict`` keys are ``nn.Conv2d``'s."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = check_dtype(dtype)

    def forward(self, x):
        dt = compute_dtype(self.compute_dtype, x)
        if dt == torch.float32 and x.dtype == torch.float32:
            return super().forward(x)
        y = self._conv(x, dt)
        if self.bias is None:
            return y
        return y + self.bias.to(dt)[:, None, None]

    def forward_f32(self, x):
        """The output as a consumer that casts it to float32 reads it: in
        a bf16 compute dtype the conv rounded to bf16 plus the bf16 bias,
        added in float32 and not rounded, or without a bias the conv of the
        bf16 operands in float32, its cotangent rounded to bf16; else
        ``forward(x)``."""
        dt = compute_dtype(self.compute_dtype, x)
        if dt == torch.float32:
            return self.forward(x)
        if self.bias is None:
            y = F.conv2d(x.to(dt).float(), self.weight.to(dt).float(), None,
                         self.stride, self.padding, self.dilation,
                         self.groups)
        else:
            y = (self._conv(x, dt).float()
                 + self.bias.to(dt).float()[:, None, None])
        return _Bf16Cotangent.apply(y)

    def _conv(self, x, dt):
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding, self.dilation, self.groups)


def Conv(in_channels: int, out_channels: int, kernel_size: int,
         stride: int = 1, bias: bool = True, dtype=None) -> Conv2d:
    """A k x k convolution (NCHW) padded by (k - 1) // 2 on every side."""
    return Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                  padding=(kernel_size - 1) // 2, bias=bias, dtype=dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with Flax ``Dense``'s compute dtype: x, the kernel and
    the bias cast to ``dtype``, the product rounded, then ``+ bias``
    rounded again."""

    def __init__(self, *args, dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = check_dtype(dtype)

    def forward(self, x):
        dt = compute_dtype(self.compute_dtype, x)
        if dt == torch.float32 and x.dtype == torch.float32:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class ConvTransposeSame(nn.Module):
    """Flax ``ConvTranspose(features, (3,) * dims, strides=2,
    padding="SAME", use_bias=False)`` (its default
    ``transpose_kernel=False``) over 2 or 3 spatial axes (NC...): each
    spatial size n becomes 2n. Flax runs its kernel [3..., C_in, C_out] as
    a plain conv over the input dilated by 2 and padded by (2, 1)
    (``lax.conv_transpose``'s SAME padding), which is PyTorch's transposed
    conv with the kernel flipped along each spatial axis, no padding, and
    the first 2n outputs of its 2n + 1 kept. ``weight`` is PyTorch's
    [C_in, C_out, 3...] (the flipped Flax kernel)."""

    def __init__(self, in_channels: int, out_channels: int, dims: int = 2):
        super().__init__()
        self.dims = dims
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels,
                                               *(3,) * dims))
        # he-normal over Flax's fan-in, C_in 3^d (torch's "fan_out" here)
        nn.init.kaiming_normal_(self.weight, mode="fan_out")

    def forward(self, x):
        conv = F.conv_transpose3d if self.dims == 3 else F.conv_transpose2d
        y = conv(x, self.weight, stride=2)
        return y[(..., *(slice(0, 2 * n) for n in x.shape[2:]))]
