"""Cost volumes (NHWC features, D after W): correlation, concat, difference
and group-wise correlation.

Counterpart of ``stereoformer_tpu/ops/cost_volume.py``
(``correlation_volume``, ``concat_volume``, ``difference_volume`` and
``gwc_volume``) and of the correlation's Pallas kernel
``ops/pallas/corr_band.py::corr_band``:

    out[b,h,w,d] = mean_c left[b,h,w,c] * right[b,h,w-d,c],   0 where w < d.

``correlation_volume`` calls the custom op ``stereoformer::corr_band``
(``corr_band_op``): the plain version for CPU tensors, the CUDA kernel
``csrc/corr_band.cu`` for CUDA tensors, counting launches in
``correlation_volume.launches``. Its gradient on the GPU is the shift form of
``ops/pallas/corr_band.py::_bwd``, which the JAX package leaves to XLA: D
shifted products in plain torch ops (``correlation_volume_backward``); on
the CPU autograd of the plain version.

bf16 features give a bf16 volume, as ``correlation_volume_matmul`` gives
it: the products summed in float32, divided by C and rounded once, through
the op ``stereoformer::corr_band_bf16``. CPU tensors take the plain version
of that form; CUDA tensors launch the
kernel's bf16 form (``corr_band_forward_bf16``, on the bf16 tensor cores:
persistent blocks of 16-pixel warps over tasks (b, h, tile, span) on the
grid ``corr_bf16_plan`` picks), counted in
``correlation_volume.bf16_launches``. Its backward is the Pallas ``_bwd``'s
in bf16: the shift form in float32 on the widened features and cotangent,
dleft and dright each rounded once to bf16.
"""

from __future__ import annotations

import functools
import types

import torch

from .. import kernels
from .local_volume import D_MAX


# csrc/corr_band.cu's bf16 geometry (namespace bfc): channels a stage, the
# n8 tiles of a warp's templates, the widest span when D is split; and the
# block widths (warps of 16 pixels) the plan takes
BF16_KC = 64
BF16_NT = (5, 8, 14, 18)
BF16_MAX_SPAN = 128
BF16_WARPS = (8, 4, 2, 1)
# an H100 SM: shared memory, and what each resident block reserves of it;
# registers hold 16 warps of the kernel (__launch_bounds__(256, 2): at most
# 128 registers a thread)
_SMEM_PER_SM = 233472
_SMEM_RESERVED = 1024
_WARPS_PER_SM = 16


def corr_bf16_span(D: int) -> tuple:
    """(span, spans, nt) of the bf16 kernel for D disparities: one span of
    D when a warp's largest template holds it (16 + D - 1 R columns in
    8 * 18), else ceil(D / 128) spans of a multiple of 8; nt, the n8 tiles
    of the smallest template that holds a span."""
    if D <= 8 * BF16_NT[-1] - 15:
        span, spans = D, 1
    else:
        spans = -(-D // BF16_MAX_SPAN)
        span = (-(-D // spans) + 7) // 8 * 8
    nt = next(n for n in BF16_NT if 8 * n - 15 >= span)
    return span, spans, nt


def corr_bf16_ring(nt: int) -> tuple:
    """(channels a stage, stages) of the kernel's ring for a warp of nt n8
    tiles (bfc::stages): 3 stages up to 8 tiles, 2 past them."""
    return BF16_KC, 3 if nt <= 8 else 2


def corr_bf16_smem(warps: int, nt: int, ring=None) -> int:
    """Shared memory bytes of a block (csrc/corr_band.cu, bfc::smem_bytes):
    the ring (``ring``, default ``corr_bf16_ring(nt)``) of L tiles and R
    slabs; the warps' band tiles take the slot of a task's last stage."""
    kc, stages = ring or corr_bf16_ring(nt)
    slab = 16 * (warps - 1) + 8 * (nt + nt % 2)
    return stages * (16 * warps + slab) * kc * 2


@functools.lru_cache(maxsize=256)
def corr_bf16_plan(B: int, H: int, W: int, C: int, D: int, sms: int,
                   warps: int | None = None,
                   ring=None) -> types.MappingProxyType:
    """The bf16 kernel's grid for L, R [B, H, W, C] and D disparities on a
    card with ``sms`` SMs. A task is (b, h, tile of 16 * warps pixels,
    span); the blocks are persistent, block i taking tasks i, i + blocks,
    ..., so SM s (blocks s, s + sms, ...) takes every sms-th task.
    ``blocks`` is at most one wave of resident blocks (``per_sm`` by
    shared memory, for the ring ``ring``, and registers) and at most the
    tasks. The width (``warps``, unless given) is, of those that keep two
    blocks on an SM (one's loads land while the other computes; any that
    fits if none does), the one whose busiest SM moves the fewest bytes:
    ceil(tasks / sms) tasks of the mean bytes a task moves (the L and R
    rows inside the image, the outputs; ``cost``, in bf16 elements). ->
    a read-only dict(warps, span, spans, nt, tiles, tasks, per_sm, blocks,
    smem, cost)."""
    span, spans, nt = corr_bf16_span(D)
    best = None
    for nw in (warps,) if warps else BF16_WARPS:
        smem = corr_bf16_smem(nw, nt, ring)
        per_sm = min(_SMEM_PER_SM // (smem + _SMEM_RESERVED),
                     _WARPS_PER_SM // nw)
        stage = smem // (ring or corr_bf16_ring(nt))[1]
        if not per_sm or 32 * nw * ((-(-span // 8) * 8) | 8) > stage:
            continue   # the block or its band tiles (in a stage) do not fit
        tw = 16 * nw
        tiles = -(-W // tw)
        tasks = B * H * tiles * spans
        moved = 0
        for w0 in range(0, tiles * tw, tw):
            lreal = min(tw, W - w0)
            for dspan in range(0, spans * span, span):
                rbase = w0 - dspan - (span - 1)
                rreal = max(0, min(W, rbase + tw + span - 1) - max(0, rbase))
                moved += (lreal + rreal) * C + lreal * min(span, D - dspan)
        cost = -(-tasks // sms) * moved / (tiles * spans)
        if best is None or (per_sm < 2, cost) < (best["per_sm"] < 2,
                                                   best["cost"]):
            best = {"cost": cost, "warps": nw, "span": span, "spans": spans,
                    "nt": nt, "tiles": tiles, "tasks": tasks,
                    "per_sm": per_sm, "blocks": min(tasks, sms * per_sm),
                    "smem": smem}
    if best is None:
        raise ValueError(f"corr_band_bf16: {warps} warps a block do not fit "
                         f"at D = {D}")
    return types.MappingProxyType(best)   # cached: read-only


def correlation_volume_plain(left: torch.Tensor, right: torch.Tensor,
                             max_disp: int) -> torch.Tensor:
    """The plain version: D shifted products, each averaged over C. bf16
    features are multiplied and summed in float32 (their products are
    exact there) and the volume is rounded to bf16 once."""
    if left.dtype == torch.bfloat16:
        return correlation_volume_plain(left.float(), right.float(),
                                        max_disp).to(torch.bfloat16)
    B, H, W, _ = left.shape
    out = left.new_zeros((B, H, W, max_disp))
    for d in range(min(max_disp, W)):
        out[:, :, d:, d] = (left[:, :, d:, :] * right[:, :, : W - d, :]).mean(-1)
    return out


def correlation_volume_backward(left: torch.Tensor, right: torch.Tensor,
                                grad: torch.Tensor):
    """The gradient of the correlation volume by shifts: with g = grad / C,
    dleft[w] = sum_d g[w, d] * right[w - d] and
    dright[v] = sum_d g[v + d, d] * left[v + d], over w >= d.
    left, right [B, H, W, C], grad [B, H, W, D] -> (dleft, dright). bf16
    features and cotangent are widened to float32 and dleft and dright
    rounded to bf16 once, as the Pallas ``_bwd`` does."""
    if left.dtype == torch.bfloat16:
        dleft, dright = correlation_volume_backward(
            left.float(), right.float(), grad.float())
        return dleft.to(left.dtype), dright.to(right.dtype)
    W, C = left.shape[2], left.shape[3]
    g = grad / C
    dleft = torch.zeros_like(left)
    dright = torch.zeros_like(right)
    for d in range(min(grad.shape[-1], W)):
        gd = g[:, :, d:, d:d + 1]
        dleft[:, :, d:] += gd * right[:, :, :W - d]
        dright[:, :, :W - d] += gd * left[:, :, d:]
    return dleft, dright


def _launch(left: torch.Tensor, right: torch.Tensor,
            max_disp: int) -> torch.Tensor:
    """One launch of the kernel (its bf16 form for bf16 features)."""
    bf16 = left.dtype == torch.bfloat16
    name = "corr_band_bf16" if bf16 else "corr_band"
    kernels.check_inputs(name, left, right)
    if left.dim() != 4 or left.shape != right.shape:
        raise ValueError(
            f"corr_band: left and right must be [B, H, W, C] of one "
            f"shape, got {tuple(left.shape)} and {tuple(right.shape)}")
    B, H, W, C = left.shape
    mult = 8 if bf16 else 4   # 16 bytes
    if C % mult or not 0 < max_disp <= D_MAX:
        raise ValueError(
            f"{name}: the kernel takes C a multiple of {mult} and "
            f"0 < max_disp <= {D_MAX}, got C={C}, max_disp={max_disp}")
    out = torch.empty((B, H, W, max_disp), dtype=left.dtype,
                      device=left.device)
    args = (left.data_ptr(), right.data_ptr(), out.data_ptr(), B, H, W,
            C, max_disp)
    if bf16:
        sms = torch.cuda.get_device_properties(
            left.device).multi_processor_count
        plan = corr_bf16_plan(B, H, W, C, max_disp, sms)
        kernels.launch(name, left.device, *args, plan["warps"],
                       plan["span"], plan["blocks"])
        correlation_volume.bf16_launches += 1
    else:
        kernels.launch(name, left.device, *args)
        correlation_volume.launches += 1
    return out


# the kernel's two forms as custom ops: the launch on CUDA tensors, the
# plain version on CPU tensors
corr_band_op = torch.library.custom_op(
    f"{kernels.OPS}::corr_band", _launch, mutates_args=(),
    device_types="cuda")
corr_band_bf16_op = torch.library.custom_op(
    f"{kernels.OPS}::corr_band_bf16", _launch, mutates_args=(),
    device_types="cuda")


def _fake(left, right, max_disp):
    return left.new_empty((*left.shape[:3], max_disp))


def _setup(ctx, inputs, output):
    left, right, ctx.max_disp = inputs
    ctx.save_for_backward(left, right)


def _backward(ctx, grad):
    """On the card the shift form (``correlation_volume_backward``); on the
    CPU autograd of the plain version."""
    left, right = ctx.saved_tensors
    if left.device.type == "cpu":
        return (*kernels.plain_vjp(correlation_volume_plain, (left, right),
                                   grad, ctx.needs_input_grad,
                                   ctx.max_disp), None)
    return (*correlation_volume_backward(left, right, grad), None)


for _def in (corr_band_op, corr_band_bf16_op):
    _def.register_kernel("cpu")(correlation_volume_plain)
    _def.register_fake(_fake)
    _def.register_autograd(_backward, setup_context=_setup)


def correlation_volume(left: torch.Tensor, right: torch.Tensor,
                       max_disp: int) -> torch.Tensor:
    """Correlation volume of NHWC features left, right [B, H, W, C] ->
    [B, H, W, max_disp], through the op ``stereoformer::corr_band`` (or
    ``corr_band_bf16`` for bf16 features): CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    op = corr_band_bf16_op if left.dtype == torch.bfloat16 else corr_band_op
    return op(left, right, max_disp)


correlation_volume.launches = 0
correlation_volume.bf16_launches = 0


def concat_volume(left: torch.Tensor, right: torch.Tensor,
                  max_disp: int) -> torch.Tensor:
    """Concat volume: out[b, h, w, d] = [left[b, h, w], right[b, h, w - d]],
    the whole 2C slice zero where w < d. left, right [B, H, W, C] ->
    [B, H, W, max_disp, 2C]."""
    B, H, W, C = left.shape
    out = left.new_zeros((B, H, W, max_disp, 2 * C))
    for d in range(min(max_disp, W)):
        out[:, :, d:, d, :C] = left[:, :, d:]
        out[:, :, d:, d, C:] = right[:, :, :W - d]
    return out


def difference_volume(left: torch.Tensor, right: torch.Tensor,
                      max_disp: int) -> torch.Tensor:
    """out[b, h, w, d] = left[b, h, w] - right[b, h, w - d], zero where
    w < d: [B, H, W, C] -> [B, H, W, D, C]."""
    B, H, W, C = left.shape
    out = left.new_zeros((B, H, W, max_disp, C))
    for d in range(min(max_disp, W)):
        out[:, :, d:, d] = left[:, :, d:] - right[:, :, :W - d]
    return out


def gwc_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
               num_groups: int) -> torch.Tensor:
    """Group-wise correlation volume: out[b, h, w, d, g] = mean over the
    channels c of group g of left[b, h, w, c] * right[b, h, w - d, c], zero
    where w < d. left, right [B, H, W, C], C a multiple of ``num_groups``
    -> [B, H, W, max_disp, num_groups].

    D shifted products, as ``correlation_volume_plain``; the JAX package
    forms the [W, W] square and takes its band with a one-hot selector, a
    TPU device that computes the same values (and at eval holds a
    [B, H, G, W, W] square)."""
    B, H, W, C = left.shape
    if C % num_groups:
        raise ValueError(f"C = {C} is not a multiple of num_groups = "
                         f"{num_groups}")
    cpg = C // num_groups
    lg = left.reshape(B, H, W, num_groups, cpg)
    rg = right.reshape(B, H, W, num_groups, cpg)
    out = left.new_zeros((B, H, W, max_disp, num_groups))
    for d in range(min(max_disp, W)):
        out[:, :, d:, d] = (lg[:, :, d:] * rg[:, :, :W - d]).sum(-1) / cpg
    return out
