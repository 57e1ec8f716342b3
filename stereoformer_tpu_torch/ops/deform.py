"""Modulated deformable convolution (DCNv2), NHWC.

Counterparts of ``stereoformer_tpu/ops/deform.py`` (``bilinear_sample_2d``,
``deform_columns``, ``modulated_deform_conv``, ``_window_pads``,
``modulated_deform_conv_windowed``) and of its Pallas kernel
``ops/pallas/deform_sample.py::deform_conv_fused``.

Layouts as there: x [B, H, W, C]; offsets [B, Ho, Wo, K, 2] as (dy, dx) per
tap, K = k*k taps in (ky, kx) row-major order; mask [B, Ho, Wo, K] (after
the sigmoid) or None; weight [K*C, Co], tap-major (ky, kx, cin).

``modulated_deform_conv`` is the gather form (exact, unbounded offsets);
``modulated_deform_conv_windowed`` clamps the offsets to +-window and sums
hat weights over the (2R+2)^2 shifts a clamped offset can reach. The hat is
JAX's ``relu(1 - max(d - s, s - d))`` and the clamp ``min(max(off, -R), R)``:
``torch.maximum`` splits a tie's gradient in half and ``relu`` passes none
at 0, as JAX's do, so at integer offsets (the zero-initialised offset conv
gives exactly 0) the offset gradient is JAX's exactly, and at +-R the clamp
passes half.

``deform_conv_fused`` is the windowed form without bias, the custom op
``stereoformer::deform_sample`` (``deform_sample_op``): CPU tensors take
the plain windowed form; CUDA tensors launch the fused kernel
``csrc/deform_sample.cu`` (x, offsets, mask and weight in, out out, tiled
by the kernel's C entry) or raise, counting launches in
``deform_conv_fused.launches``. Its gradient is autograd of the plain
windowed form on both devices, as the Pallas kernel's VJP rematerialises
through the XLA windowed form.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels


def bilinear_sample_2d(img: torch.Tensor, y: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Sample img [B, H, W, C] at continuous (y, x) [B, P], zero outside the
    image (DCN's ``mdcn_im2col_bilinear``). Returns [B, P, C]."""
    B, H, W, C = img.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    ty = (y - y0)[..., None]
    tx = (x - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    flat = img.reshape(B, H * W, C)

    def tap(yi, xi):
        ok = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return v * ok[..., None].to(img.dtype)

    return (tap(y0, x0) * (1 - ty) * (1 - tx)
            + tap(y0, x0 + 1) * (1 - ty) * tx
            + tap(y0 + 1, x0) * ty * (1 - tx)
            + tap(y0 + 1, x0 + 1) * ty * tx)


def _out_size(n: int, kernel_size: int, stride: int, padding: int,
              dilation: int) -> int:
    return (n + 2 * padding - dilation * (kernel_size - 1) - 1) // stride + 1


def deform_columns(x: torch.Tensor, offsets: torch.Tensor,
                   mask: Optional[torch.Tensor], kernel_size: int = 3,
                   stride: int = 1, padding: int = 1,
                   dilation: int = 1) -> torch.Tensor:
    """Deformable im2col: each tap sampled at its offset location, times
    its mask. -> columns [B, Ho, Wo, K*C]."""
    B, H, W, C = x.shape
    k = kernel_size
    Ho = _out_size(H, k, stride, padding, dilation)
    Wo = _out_size(W, k, stride, padding, dilation)
    K = k * k
    dev, dt = x.device, x.dtype
    ho = torch.arange(Ho, device=dev, dtype=dt) * stride - padding
    wo = torch.arange(Wo, device=dev, dtype=dt) * stride - padding
    tap = torch.arange(K, device=dev)
    tap_y = torch.div(tap, k, rounding_mode="floor").to(dt) * dilation
    tap_x = (tap % k).to(dt) * dilation
    yy = ho[:, None, None] + tap_y + offsets[..., 0]       # [B, Ho, Wo, K]
    xx = wo[None, :, None] + tap_x + offsets[..., 1]
    cols = bilinear_sample_2d(x, yy.reshape(B, -1), xx.reshape(B, -1))
    cols = cols.reshape(B, Ho, Wo, K, C)
    if mask is not None:
        cols = cols * mask[..., None]
    return cols.reshape(B, Ho, Wo, K * C)


def modulated_deform_conv(x: torch.Tensor, offsets: torch.Tensor,
                          mask: Optional[torch.Tensor], weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          kernel_size: int = 3, stride: int = 1,
                          padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """DCNv2, the gather form: deformable columns x weight [K*C, Co]
    (+ bias). -> [B, Ho, Wo, Co]."""
    out = deform_columns(x, offsets, mask, kernel_size, stride, padding,
                         dilation) @ weight
    return out if bias is None else out + bias


def _window_pads(Ho: int, Wo: int, H: int, W: int, k: int, padding: int,
                 dilation: int, window: int):
    """Zero pads (top, bottom, left, right) that make every windowed sample
    an in-bounds slice: the row read is i + dilation*ky - padding + s + PT
    for s in [-window, window + 1]."""
    PT = PL = padding + window
    max_row = (Ho - 1) + dilation * (k - 1) - padding + (window + 1) + PT
    max_col = (Wo - 1) + dilation * (k - 1) - padding + (window + 1) + PL
    PB = max(0, max_row - (H + PT - 1))
    PR = max(0, max_col - (W + PL - 1))
    return PT, PB, PL, PR


def _clamp(v: torch.Tensor, r: float) -> torch.Tensor:
    """jnp.clip(v, -r, r), whose gradient is half at exactly +-r."""
    return torch.minimum(torch.maximum(v, v.new_full((), -r)),
                         v.new_full((), r))


def modulated_deform_conv_windowed(x: torch.Tensor, offsets: torch.Tensor,
                                   mask: Optional[torch.Tensor],
                                   weight: torch.Tensor,
                                   bias: Optional[torch.Tensor] = None, *,
                                   kernel_size: int = 3, stride: int = 1,
                                   padding: int = 1, dilation: int = 1,
                                   window: int = 2) -> torch.Tensor:
    """DCNv2 with offsets clamped to +-``window`` px, as hat-weighted sums
    over the static shifts s in [-R, R+1] of the zero-padded x, per tap.
    Stride 1 only. -> [B, Ho, Wo, Co]."""
    if stride != 1:
        raise NotImplementedError("windowed form supports stride=1 only")
    B, H, W, C = x.shape
    k = kernel_size
    Ho = H + 2 * padding - dilation * (k - 1)
    Wo = W + 2 * padding - dilation * (k - 1)
    R = int(window)
    S = 2 * R + 2
    PT, PB, PL, PR = _window_pads(Ho, Wo, H, W, k, padding, dilation, R)
    xpad = F.pad(x, (0, 0, PL, PR, PT, PB))

    shifts = torch.arange(-R, R + 2, dtype=x.dtype, device=x.device)
    dy = _clamp(offsets[..., 0], R)[..., None]              # [B,Ho,Wo,K,1]
    dx = _clamp(offsets[..., 1], R)[..., None]
    wy = torch.relu(1.0 - torch.maximum(dy - shifts, shifts - dy))
    wx = torch.relu(1.0 - torch.maximum(dx - shifts, shifts - dx))
    if mask is not None:
        wy = wy * mask[..., None]                          # fold modulation
    cols = []
    for kk in range(k * k):
        ky, kx = divmod(kk, k)
        r0 = dilation * ky - padding + PT - R
        c0 = dilation * kx - padding + PL - R
        # [B, Ho, Wo, C, S (rows), S (cols)]: the shifted windows of this tap
        win = xpad[:, r0:r0 + Ho + S - 1, c0:c0 + Wo + S - 1]
        win = win.unfold(1, S, 1).unfold(2, S, 1)
        cols.append(torch.einsum("bhwcyx,bhwy,bhwx->bhwc", win,
                                 wy[..., kk, :], wx[..., kk, :]))
    out = torch.cat(cols, dim=-1) @ weight
    return out if bias is None else out + bias


def _windowed(x, offsets, mask, weight, kernel_size, padding, dilation,
              window):
    return modulated_deform_conv_windowed(
        x, offsets, mask, weight.reshape(-1, weight.shape[-1]), None,
        kernel_size=kernel_size,
        padding=padding, dilation=dilation, window=window)


# the tiling that csrc/deform_sample.cu ran a call with (its struct Plan)
PLAN_FIELDS = ("rows", "mt", "ts", "halo", "nt", "kg", "smem", "grid_x",
               "grid_y", "grid_z")


def deform_sample_launch(x, offsets, mask, weight, kernel_size=3, padding=1,
                         dilation=1, window=2, plan=None):
    """The fused kernel on CUDA tensors: one launch, x and the weight in, no
    G; returns out [B, Ho, Wo, Co]. The kernel tiles the call from the
    shapes and the card's SMs. ``plan``, where given, is a dict: where it
    holds ``rows``, ``mt``, ``ts`` and ``halo``, the kernel takes that
    tiling instead, and on return it holds every field of PLAN_FIELDS as
    the kernel ran them."""
    inputs = [x, offsets, weight] + ([] if mask is None else [mask])
    kernels.check_inputs("deform_sample", *inputs)
    B, H, W, C = x.shape
    k = kernel_size
    K = k * k
    Ho = H + 2 * padding - dilation * (k - 1)
    Wo = W + 2 * padding - dilation * (k - 1)
    if weight.shape[:-1] not in ((K * C,), (K, C)):
        raise ValueError(f"deform_sample: weight must be [K*C, Co] = "
                         f"[{K * C}, Co] or [K, C, Co], got "
                         f"{tuple(weight.shape)}")
    if offsets.shape != (B, Ho, Wo, K, 2) or (
            mask is not None and mask.shape != (B, Ho, Wo, K)):
        raise ValueError(
            f"deform_sample: offsets must be [B, Ho, Wo, K, 2] = "
            f"{(B, Ho, Wo, K, 2)} and mask [B, Ho, Wo, K], got "
            f"{tuple(offsets.shape)} and "
            f"{None if mask is None else tuple(mask.shape)}")
    Co = weight.shape[-1]
    ran = None
    if plan is not None:
        ran = (ctypes.c_int * len(PLAN_FIELDS))()
        if "rows" in plan:
            ran[:4] = [int(plan[f]) for f in PLAN_FIELDS[:4]]
    out = x.new_empty((B, Ho, Wo, Co))
    kernels.launch("deform_sample", x.device, x.data_ptr(),
                   offsets.data_ptr(), 0 if mask is None else mask.data_ptr(),
                   weight.data_ptr(), out.data_ptr(), B, H, W, C, Co, k,
                   padding, dilation, int(window), ran)
    if plan is not None:
        plan.update(zip(PLAN_FIELDS, ran))
    deform_conv_fused.launches += 1
    return out


def _launch(x: torch.Tensor, offsets: torch.Tensor,
            mask: Optional[torch.Tensor], weight: torch.Tensor,
            kernel_size: int, padding: int, dilation: int,
            window: int) -> torch.Tensor:
    return deform_sample_launch(x, offsets, mask, weight, kernel_size,
                                padding, dilation, window)


# the kernel as a custom op: the launch on CUDA tensors, the plain windowed
# form on CPU tensors
deform_sample_op = torch.library.custom_op(
    f"{kernels.OPS}::deform_sample", _launch, mutates_args=(),
    device_types="cuda")
deform_sample_op.register_kernel("cpu")(_windowed)


@deform_sample_op.register_fake
def _(x, offsets, mask, weight, kernel_size, padding, dilation, window):
    return x.new_empty((*offsets.shape[:3], weight.shape[-1]))


def _setup(ctx, inputs, output):
    ctx.conf = inputs[4:]
    ctx.save_for_backward(*inputs[:4])


def _backward(ctx, grad):
    return (*kernels.plain_vjp(_windowed, ctx.saved_tensors, grad,
                               ctx.needs_input_grad, *ctx.conf),
            None, None, None, None)


deform_sample_op.register_autograd(_backward, setup_context=_setup)


def deform_conv_fused(x: torch.Tensor, offsets: torch.Tensor,
                      mask: Optional[torch.Tensor], weight: torch.Tensor,
                      kernel_size: int = 3, padding: int = 1,
                      dilation: int = 1, window: int = 2) -> torch.Tensor:
    """The windowed modulated deformable conv at stride 1, without bias:
    x [B, H, W, C], offsets [B, Ho, Wo, K, 2], mask [B, Ho, Wo, K] or None,
    weight [K*C, Co] or [K, C, Co] -> [B, Ho, Wo, Co] float32, through the
    op ``stereoformer::deform_sample``: CPU tensors take the plain windowed
    form, CUDA tensors the fused kernel; the gradient is autograd of the
    plain windowed form."""
    return deform_sample_op(x, offsets, mask, weight, kernel_size, padding,
                            dilation, int(window))


deform_conv_fused.launches = 0
