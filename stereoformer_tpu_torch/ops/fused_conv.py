"""Fused stride-1 3x3 SAME convolution (NHWC, HWIO weights), and its backward.

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
[B, H, W, Co]. The padding is zero whatever the prologue. Every call is one
call of the custom op ``stereoformer::conv2d_fused`` (``conv2d_fused_op``;
without moments its two moment outputs are empty): it takes the plain
version (``conv3x3_plain``) on CPU tensors and launches the kernel
``csrc/conv2d_fused.cu`` on CUDA tensors or raises, counting launches in
``conv2d_fused.launches`` (one count for all four entry points: they are one
kernel). Its backward is ``fused_conv_backward``, the Pallas VJPs ``_bwd``,
``_prologue_bwd`` and the moments' fold: the input gradient is the same
fused conv with flipped, io-transposed weights, the weight gradient is
``dw_conv.conv2d_dw``, the rest is elementwise torch ops and [B, C]
reductions, as XLA does them in the JAX package.

bf16 x, w, b and residual (s and t stay float32) give the bf16 form of
every entry point, the Pallas kernel's at ``out_dtype`` bf16: the products
summed in float32, the bias and the residual added and the ReLU applied in
float32, one rounding to bf16; the prologue's relu(x*s + t), x*s + t one
FMA, rounded to bf16 before the conv; the moments float32, of the rounded
outputs, through the op ``stereoformer::conv2d_fused_bf16``. CPU tensors
take its plain version; CUDA tensors launch ``conv2d_fused_forward_bf16``
(the same source, its own mainloop on the bf16 tensor cores), counted in
``conv2d_fused.bf16_launches``. Its backward rounds where the Pallas VJPs
do (``fused_conv_backward``): the moments' total cotangent summed in
float32 and rounded once; db the float32 sum cast to bf16; dx the bf16
fused conv of the bf16 cotangent (launched from the backward, counted in
``conv2d_fused.bf16_launches`` and again in
``conv2d_fused.bf16_dx_launches``); dw ``conv2d_dw``'s bf16 form; the
prologue's relu(x*s + t) rounded to bf16 for dw, its gradients in float32
from the widened dx conv, dx rounded once.

Beside them, as the JAX module keeps it, the stride-2 entry point

    conv2d_fused_s2(x, w, b, relu=False)   y = relu?(conv3x3_s2(x, w) + b)

with x [B, H, W, C] (H and W even), y [B, H/2, W/2, Co], padding 1 on every
side (the Pallas ``_forward_s2``). CPU tensors take its plain version
(``conv3x3_s2_plain``); CUDA tensors launch ``csrc/conv2d_s2.cu`` or raise,
counting launches in ``conv2d_fused_s2.launches``. Its backward is autograd
of the plain version (float32, as the kernel), as the Pallas ``_s2_bwd`` is
the XLA VJP of ``_reference_s2``. No model calls it: RAFT's stride-2 convs stay cuDNN
convs, as they stay XLA convs in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .dw_conv import conv2d_dw

# the kernel's blocks (csrc/conv2d_fused.cu): output rows and columns of
# a tile, and output channels of a block; the 3xTF32 form's 4 x 32 tiles
# and 32-channel blocks (TH, TW, CB), the bf16 form's 8 x 32 tiles (bfk::
# BTH, TW) and blocks (the NB of conv3x3_bf16_kernel) of all 64 or half of
# 96 or 128 channels where C <= kernels.BF16_FOLD_C, of 32 channels, each
# chunk's sums folded, where C is more; one moment partial per tile and
# output channel, written by the tile's channel blocks
_TILE = {torch.float32: (4, 32), torch.bfloat16: (8, 32)}
_BF16_CB = {64: 64, 96: 48, 128: 64}
# the output widths the kernel has templates for
KERNEL_CO = (64, 96, 128)


def fused_tiles(H: int, W: int, dtype: torch.dtype = torch.float32) -> int:
    """The output tiles of the fused conv's grid for one image of H x W of
    ``dtype`` (the 3xTF32 form for float32, the bf16 form for bf16)."""
    th, tw = _TILE[dtype]
    return -(-H // th) * -(-W // tw)


def fused_blocks(B: int, H: int, W: int, C: int, Co: int,
                 dtype: torch.dtype = torch.float32) -> int:
    """The blocks of the fused conv's grid for x [B, H, W, C] and y
    [B, H, W, Co] of ``dtype``."""
    cb = (32 if dtype == torch.float32 or C > kernels.BF16_FOLD_C
          else _BF16_CB[Co])
    return B * fused_tiles(H, W, dtype) * (Co // cb)


def _prologue(x, s, t):
    """(u, z) = (x s + t, relu(u)), s and t [B, C]. A bf16 x: one FMA, as
    XLA computes it (the product of a bf16 and a float32 is exact in
    float64), u float32 and z rounded to bf16; else in x's dtype."""
    s, t = s[:, None, None, :], t[:, None, None, :]
    if x.dtype == torch.bfloat16:
        u = (x.double() * s.double() + t.double()).float()
        return u, torch.relu(u).to(torch.bfloat16)
    u = x * s + t
    return u, torch.relu(u)


def conv3x3_plain(x, w, b, residual=None, relu=False, s=None, t=None,
                  with_stats=False):
    """The plain version of every entry point (same arguments); the moments
    are summed in float64 and returned as float32. bf16 inputs: float32
    arithmetic from them, one rounding of y (and of the prologue's
    output), the moments of the rounded y."""
    if x.dtype == torch.bfloat16:
        bf = torch.bfloat16
        x32 = (x if s is None else _prologue(x, s, t)[1]).float()
        y = conv3x3_plain(x32, w.float(), b.float(),
                          None if residual is None else residual.float(),
                          relu).to(bf)
        if not with_stats:
            return y
        y64 = y.double()
        return (y, y64.sum((1, 2)).float(), y64.square().sum((1, 2)).float())
    if s is not None:
        x = _prologue(x, s, t)[1]
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


def _launch(x, w, b, residual, s, t, relu, with_stats):
    """One launch of the kernel (its bf16 form for a bf16 x): y, or
    (y, S1, S2) with the moments."""
    bf16 = x.dtype == torch.bfloat16
    name = "conv2d_fused_bf16" if bf16 else "conv2d_fused"
    if bf16:
        kernels.check_inputs(
            name, *[a for a in (x, w, b, residual) if a is not None])
        if s is not None:
            kernels.check_inputs(name, s, t, dtype=torch.float32)
    else:
        kernels.check_inputs(
            name, *[a for a in (x, w, b, residual, s, t) if a is not None])
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3):
        raise ValueError(
            f"conv2d_fused: the kernel takes x [B, H, W, C] and w "
            f"[3, 3, C, Co], got {tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, C = x.shape
    Co = w.shape[3]
    if w.shape[2] != C or C % 8 or Co not in KERNEL_CO:
        raise ValueError(
            f"conv2d_fused: the kernel takes C a multiple of 8 and Co in "
            f"{KERNEL_CO}, got w {tuple(w.shape)} for C={C}")
    if b.shape != (Co,):
        raise ValueError(f"conv2d_fused: b must be [{Co}]")
    if residual is not None and residual.shape != (B, H, W, Co):
        raise ValueError(f"conv2d_fused: residual must be {(B, H, W, Co)}")
    if s is not None and (s.shape != (B, C) or t.shape != (B, C)):
        raise ValueError(f"conv2d_fused: s and t must be [{B}, {C}]")
    if H * W * C >= 2 ** 31:
        raise ValueError(
            f"conv2d_fused: the kernel takes H * W * C < 2^31, got {H * W * C}")
    y = x.new_empty((B, H, W, Co))
    part = s1 = s2 = None
    if with_stats:
        f32 = dict(dtype=torch.float32)
        part = x.new_empty((B, fused_tiles(H, W, x.dtype), 2, Co), **f32)
        s1, s2 = x.new_empty((B, Co), **f32), x.new_empty((B, Co), **f32)

    def ptr(a):
        return None if a is None else a.data_ptr()

    kernels.launch(name, x.device, x.data_ptr(), w.data_ptr(),
                   b.data_ptr(), ptr(s), ptr(t), ptr(residual), y.data_ptr(),
                   ptr(part), ptr(s1), ptr(s2), B, H, W, C, Co, int(relu))
    if bf16:
        conv2d_fused.bf16_launches += 1
    else:
        conv2d_fused.launches += 1
    return (y, s1, s2) if with_stats else y


def _dx_conv(g, w_rot, zero):
    """The dx conv of the backward: the fused conv of the cotangent with
    the flipped, io-transposed weights and no bias, through the op (plain
    on CPU tensors, a launch of the kernel on CUDA tensors, its bf16 form
    counted also in ``conv2d_fused.bf16_dx_launches``)."""
    y = _op(g.dtype)(g, w_rot, zero, None, None, None, False, False)[0]
    if g.device.type != "cpu" and g.dtype == torch.bfloat16:
        conv2d_fused.bf16_dx_launches += 1
    return y


def fused_conv_backward(x, w, y, gy, gs1=None, gs2=None, s=None, t=None,
                        relu=False, has_residual=False, needs=(True,) * 6):
    """The VJP of ``conv3x3_fused`` (the Pallas ``_bwd``, ``_prologue_bwd``
    and ``_stats_total_cotangent``): from the forward's x, w, s, t and its
    output y (needed with ``relu`` or moments, else None), and the
    cotangents of y, S1 and S2 (any of them None for zero), returns
    (dx, dw, db, dresidual, ds, dt), None for each input that is absent or
    that ``needs`` (x, w, b, residual, s, t) does not ask for.

    g = gy + gs1 + 2 y gs2; gpre = g where y > 0 with ``relu`` (the saved
    output's mask: 0 at y == 0); db = sum gpre; dresidual = gpre;
    dw = conv2d_dw(z, gpre) with z = relu(x s + t) or x; dz = the fused conv
    of gpre with the flipped, io-transposed w and no bias; with the prologue
    du = dz where x s + t > 0, dx = du s, ds = sum_hw du x, dt = sum_hw du,
    else dx = dz.

    bf16 x, w, y and gy (s, t and the moments' cotangents float32) round as
    the Pallas VJPs: g summed in float32 and rounded once to bf16; db the
    float32 sum, cast to bf16 (b's dtype); dw and dz bf16 (float32 sums,
    one rounding); with the prologue x s + t one FMA in float32, z its ReLU
    rounded to bf16, du from dz widened to float32, dx = du s rounded once,
    ds and dt float32."""
    need_x, need_w, need_b, need_res, need_s, need_t = needs
    g = gy if gy is not None else torch.zeros_like(y)
    if gs1 is not None or gs2 is not None:
        g = g.float()
        if gs1 is not None:
            g = g + gs1[:, None, None, :]
        if gs2 is not None:
            g = g + 2.0 * y.float() * gs2[:, None, None, :]
        g = g.to(y.dtype)
    if relu:
        g = torch.where(y > 0, g, 0.0)
    if not g.is_contiguous():
        # the cotangent of an NCHW consumer; the kernels read NHWC
        g = g.contiguous()
        conv2d_fused.grad_copies += 1
    db = g.float().sum((0, 1, 2)).to(w.dtype) if need_b else None
    dres = g if has_residual and need_res else None
    u, z = (None, None) if s is None else _prologue(x, s, t)
    dw = conv2d_dw(x if z is None else z, g) if need_w else None
    dx = ds = dt = None
    if need_x or need_s or need_t:
        w_rot = w.flip((0, 1)).transpose(2, 3).contiguous()
        dz = _dx_conv(g, w_rot, w.new_zeros(w.shape[2]))
        if u is None:
            dx = dz
        else:
            du = torch.where(u > 0, dz.float(), 0.0)
            dx = (du * s[:, None, None, :]).to(x.dtype) if need_x else None
            ds = (du * x.float()).sum((1, 2)) if need_s else None
            dt = du.sum((1, 2)) if need_t else None
    return dx, dw, db, dres, ds, dt


def _plain(x, w, b, residual, s, t, relu, with_stats):
    out = conv3x3_plain(x, w, b, residual, relu, s, t, with_stats)
    return out if with_stats else (out, *_no_stats(x))


def _no_stats(x):
    """The moments' outputs of a call without moments: two empty tensors
    (an op returns a fixed number of tensors)."""
    return tuple(x.new_empty((0,), dtype=torch.float32) for _ in range(2))


def _launch_op(x, w, b, residual, s, t, relu, with_stats):
    out = _launch(x, w, b, residual, s, t, relu, with_stats)
    return out if with_stats else (out, *_no_stats(x))


_SIGNATURE = dict(mutates_args=(), device_types="cuda",
                  schema="(Tensor x, Tensor w, Tensor b, Tensor? residual, "
                         "Tensor? s, Tensor? t, bool relu, bool with_stats) "
                         "-> (Tensor, Tensor, Tensor)")
conv2d_fused_op = torch.library.custom_op(
    f"{kernels.OPS}::conv2d_fused", _launch_op, **_SIGNATURE)
conv2d_fused_bf16_op = torch.library.custom_op(
    f"{kernels.OPS}::conv2d_fused_bf16", _launch_op, **_SIGNATURE)


def _op(dtype):
    """The op of a conv of ``dtype``."""
    return conv2d_fused_bf16_op if dtype == torch.bfloat16 else conv2d_fused_op


def _fake(x, w, b, residual, s, t, relu, with_stats):
    y = x.new_empty((*x.shape[:3], w.shape[3]))
    if not with_stats:
        return (y, *_no_stats(x))
    return (y, *(x.new_empty((x.shape[0], w.shape[3]), dtype=torch.float32)
                 for _ in range(2)))


def _setup(ctx, inputs, output):
    x, w, b, residual, s, t, relu, with_stats = inputs
    ctx.relu, ctx.has_residual = relu, residual is not None
    ctx.with_stats = with_stats
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(x, w, s, t,
                          output[0] if relu or with_stats else None)


def _backward(ctx, gy, gs1, gs2):
    x, w, s, t, y = ctx.saved_tensors
    if not ctx.with_stats:
        gs1 = gs2 = None   # the empty moments' outputs
    grads = fused_conv_backward(x, w, y, gy, gs1, gs2, s, t, ctx.relu,
                                ctx.has_residual, ctx.needs_input_grad[:6])
    return (*grads, None, None)


for _def in (conv2d_fused_op, conv2d_fused_bf16_op):
    _def.register_kernel("cpu")(_plain)
    _def.register_fake(_fake)
    _def.register_autograd(_backward, setup_context=_setup)


def conv3x3_fused(x, w, b, residual=None, relu=False, s=None, t=None,
                  with_stats=False):
    """Every entry point in one differentiable call, with ``conv3x3_plain``'s
    arguments, through the op ``stereoformer::conv2d_fused`` (or
    ``conv2d_fused_bf16`` for a bf16 x): the plain version on CPU tensors,
    the kernel on CUDA tensors; the backward is ``fused_conv_backward`` on
    either."""
    y, s1, s2 = _op(x.dtype)(x, w, b, residual, s, t, relu, with_stats)
    return (y, s1, s2) if with_stats else y


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
conv2d_fused.bf16_launches = 0
# of the bf16 launches, those of the backward's dx conv
conv2d_fused.bf16_dx_launches = 0
# copies of a cotangent to NHWC that the backward had to make
conv2d_fused.grad_copies = 0


def conv3x3_s2_plain(x, w, b, relu=False):
    """The plain version of ``conv2d_fused_s2``: x [B, H, W, C], w
    [3, 3, C, Co], b [Co] -> [B, ceil(H/2), ceil(W/2), Co]."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, stride=2,
                 padding=1).permute(0, 2, 3, 1)
    return torch.relu(y) if relu else y


# the stride-2 kernel's block (csrc/conv2d_s2.cu: TH, TW, CB): output rows,
# output columns and output channels
_S2_TILE_H, _S2_TILE_W, _S2_CB = 4, 32, 32


def s2_blocks(B: int, H: int, W: int, Co: int) -> int:
    """The blocks of the stride-2 kernel's grid for x [B, H, W, .] and Co
    outputs."""
    return (B * -(-(H // 2) // _S2_TILE_H) * -(-(W // 2) // _S2_TILE_W)
            * -(-Co // _S2_CB))


def _launch_s2(x, w, b, relu):
    kernels.check_inputs("conv2d_s2", x, w, b)
    B, H, W, C = x.shape
    Co = w.shape[3]
    if w.shape[:3] != (3, 3, C) or b.shape != (Co,):
        raise ValueError(
            f"conv2d_s2: the kernel takes w [3, 3, {C}, Co] and b [Co], got "
            f"{tuple(w.shape)} and {tuple(b.shape)}")
    if H * W * C >= 2 ** 31:
        raise ValueError(
            f"conv2d_s2: the kernel takes H * W * C < 2^31, got {H * W * C}")
    y = x.new_empty((B, H // 2, W // 2, Co))
    kernels.launch("conv2d_s2", x.device, x.data_ptr(), w.data_ptr(),
                   b.data_ptr(), y.data_ptr(), B, H, W, C, Co, int(relu))
    conv2d_fused_s2.launches += 1
    return y


class _FusedConvS2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, relu):
        ctx.relu = relu
        ctx.save_for_backward(x, w, b)
        if all(a.device.type == "cpu" for a in (x, w, b)):
            return conv3x3_s2_plain(x, w, b, relu)
        return _launch_s2(x, w, b, relu)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            args = [a.detach().requires_grad_(n)
                    for a, n in zip(ctx.saved_tensors, need)]
            y = conv3x3_s2_plain(*args, ctx.relu)
            got = iter(torch.autograd.grad(
                y, [a for a, n in zip(args, need) if n], g))
        return (*(next(got) if n else None for n in need), None)


def conv2d_fused_s2(x, w, b, relu: bool = False):
    """y = relu?(conv3x3_s2(x, w) + b): x [B, H, W, C] with H and W even,
    w [3, 3, C, Co], b [Co] -> [B, H/2, W/2, Co]. Raises ``ValueError`` on
    an odd H or W, as the JAX kernel asserts."""
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(
            f"conv2d_fused_s2: x must be [B, H, W, C] with H and W even, got "
            f"{tuple(x.shape)}")
    return _FusedConvS2.apply(x, w, b, relu)


conv2d_fused_s2.launches = 0
