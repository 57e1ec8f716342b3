"""Local cost-volume refinement: candidates, hat re-sample, local soft-argmin,
and the fixed-radius and variance-scaled refiners built on them.

Counterpart of ``stereoformer_tpu/ops/local_volume.py`` (``make_candidates``,
``resample_volume_hat``, ``local_soft_argmin``, ``fixed_local_cost_volume``,
``variance_local_cost_volume``) and of its Pallas kernel
``ops/pallas/local_refine.py::fused_local_soft_argmin``.

``local_soft_argmin`` calls the custom op ``stereoformer::local_soft_argmin``
(``local_soft_argmin_op``): the plain version for CPU tensors, whose
autograd is its gradient there and gives the same gradient as JAX's (the
clip's tie at a bound meets a hat derivative of 0 there, so no tie mask is
needed). For CUDA tensors it launches the CUDA kernel
``csrc/local_soft_argmin.cu`` and, for the gradient, the op
``stereoformer::local_soft_argmin_bwd``, the kernel
``csrc/local_soft_argmin_bwd.cu`` (the Pallas ``_backward``; on CPU tensors
its closed form ``local_soft_argmin_backward_plain``), counting launches in
``local_soft_argmin.launches`` and ``local_soft_argmin.backward_launches``.
"""

from __future__ import annotations

import torch

from .. import kernels
from .softargmin import disparity_variance

# the most volume bins and candidates the kernels take: a block's shared
# rows, 32 pixels x (D + 3 S + 2) floats at most in the backward, stay
# within the H100's 227 KB (max_disp up to 8192, num_samples up to 127)
D_MAX, S_MAX = 1024, 128


def make_candidates(lower: torch.Tensor, upper: torch.Tensor,
                    cur_disp: torch.Tensor, num_samples: int,
                    max_disp: int, consider_valid: bool = True,
                    extra_invalid: torch.Tensor | None = None) -> torch.Tensor:
    """S+1 = num_samples+1 uniform candidates in [lower, upper] per pixel.

    lower, upper, cur_disp: [B, H, W, 1] -> [B, H, W, S+1], with max_disp
    the volume's D. ``consider_valid=True``: a pixel whose range leaves
    [0, max_disp - 1) (lower < 0 or upper >= max_disp - 1), or where
    ``extra_invalid`` (broadcast to [B, H, W, 1]) is nonzero, collapses
    every candidate to cur_disp. ``consider_valid=False``: the bounds are
    clamped instead, lower to >= 0 and upper to [0, max_disp], as JAX's
    ``jnp.clip`` (half the gradient at a tie)."""
    steps = torch.arange(num_samples + 1, dtype=lower.dtype,
                         device=lower.device)
    if not consider_valid:
        zero = lower.new_full((), 0.0)
        lower = torch.maximum(lower, zero)
        upper = torch.minimum(torch.maximum(upper, zero),
                              upper.new_full((), float(max_disp)))
        return lower + steps * ((upper - lower) / num_samples)
    invalid = (lower < 0) | (upper >= max_disp - 1)
    if extra_invalid is not None:
        invalid = invalid | (extra_invalid != 0)
    invalid = invalid.to(lower.dtype)
    cands = lower + steps * ((upper - lower) / num_samples)
    return cands * (1.0 - invalid) + invalid * cur_disp


def resample_volume_hat(volume: torch.Tensor,
                        candidates: torch.Tensor) -> torch.Tensor:
    """Linear re-sample of volume [B, H, W, D] at candidates [B, H, W, S],
    clipped to [0, D-1]: out_s = sum_d v_d * max(0, 1 - |c_s - d|)."""
    D = volume.shape[-1]
    c = candidates.clamp(0, D - 1)
    d = torch.arange(D, dtype=volume.dtype, device=volume.device)
    w = torch.relu(1.0 - (c[..., None] - d).abs())
    return torch.einsum("bhwsd,bhwd->bhws", w, volume)


def local_soft_argmin_plain(volume: torch.Tensor,
                            candidates: torch.Tensor) -> torch.Tensor:
    """The plain version: re-sample, softmax over S, expectation of the
    unclipped candidates. -> [B, H, W, 1]."""
    score = torch.softmax(resample_volume_hat(volume, candidates), dim=-1)
    return (score * candidates).sum(-1, keepdim=True)


def local_soft_argmin_backward_plain(volume: torch.Tensor,
                                     candidates: torch.Tensor,
                                     g: torch.Tensor):
    """The plain version of the backward, the closed form of the Pallas
    ``_bwd_kernel``: volume [B, H, W, D], candidates [B, H, W, S], the
    output's cotangent g [B, H, W, 1] -> (dvolume, dcandidates).

    The clip's derivative is 1 inside (0, D-1), 0 outside and 0.5 at a bound;
    |delta|'s is sign(delta) (0 at delta = 0); the hat's relu passes nothing
    at |delta| >= 1."""
    D = volume.shape[-1]
    c = candidates.clamp(0, D - 1)
    d = torch.arange(D, dtype=volume.dtype, device=volume.device)
    delta = c[..., None] - d                                   # [.., S, D]
    m = delta.abs()
    w = torch.relu(1.0 - m)
    local = torch.einsum("...sd,...d->...s", w, volume)
    score = torch.softmax(local, dim=-1)
    out = (score * candidates).sum(-1, keepdim=True)
    dlocal = g * score * (candidates - out)
    dvolume = torch.einsum("...s,...sd->...d", dlocal, w)
    dw = dlocal[..., None] * volume[..., None, :]
    dc = -(dw * (m < 1.0) * torch.sign(delta)).sum(-1)
    cg = (torch.where(candidates > 0, 1.0,
                      torch.where(candidates < 0, 0.0, 0.5))
          * torch.where(candidates < D - 1, 1.0,
                        torch.where(candidates > D - 1, 0.0, 0.5)))
    return dvolume, g * score + dc * cg


def _launch(volume: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel ``local_soft_argmin``."""
    kernels.check_inputs("local_soft_argmin", volume, candidates)
    if (volume.dim() != 4 or candidates.dim() != 4
            or volume.shape[:3] != candidates.shape[:3]):
        raise ValueError(
            f"local_soft_argmin: volume [B, H, W, D] and candidates "
            f"[B, H, W, S] must share B, H, W, got {tuple(volume.shape)} "
            f"and {tuple(candidates.shape)}")
    B, H, W, D = volume.shape
    S = candidates.shape[-1]
    if S > S_MAX or D > D_MAX:
        raise ValueError(
            f"local_soft_argmin: the kernel takes S <= {S_MAX} and "
            f"D <= {D_MAX}, got S={S}, D={D}")
    out = torch.empty((B, H, W, 1), dtype=torch.float32,
                      device=volume.device)
    kernels.launch("local_soft_argmin", volume.device, volume.data_ptr(),
                   candidates.data_ptr(), out.data_ptr(), B * H * W, D, S)
    local_soft_argmin.launches += 1
    return out


def _launch_bwd(volume: torch.Tensor, candidates: torch.Tensor,
                g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel ``local_soft_argmin_bwd``: (dvolume,
    dcandidates) from the output's cotangent g [B, H, W, 1]."""
    kernels.check_inputs("local_soft_argmin_bwd", volume, candidates, g)
    dvolume = torch.empty_like(volume)
    dcandidates = torch.empty_like(candidates)
    B, H, W, D = volume.shape
    kernels.launch("local_soft_argmin_bwd", volume.device,
                   volume.data_ptr(), candidates.data_ptr(), g.data_ptr(),
                   dvolume.data_ptr(), dcandidates.data_ptr(), B * H * W,
                   D, candidates.shape[-1])
    local_soft_argmin.backward_launches += 1
    return dvolume, dcandidates


# the kernels as custom ops: the launch on CUDA tensors, the plain version
# on CPU tensors
local_soft_argmin_op = torch.library.custom_op(
    f"{kernels.OPS}::local_soft_argmin", _launch, mutates_args=(),
    device_types="cuda")
local_soft_argmin_bwd_op = torch.library.custom_op(
    f"{kernels.OPS}::local_soft_argmin_bwd", _launch_bwd, mutates_args=(),
    device_types="cuda")
local_soft_argmin_op.register_kernel("cpu")(local_soft_argmin_plain)
local_soft_argmin_bwd_op.register_kernel("cpu")(
    local_soft_argmin_backward_plain)


@local_soft_argmin_op.register_fake
def _(volume, candidates):
    return volume.new_empty((*volume.shape[:3], 1))


@local_soft_argmin_bwd_op.register_fake
def _(volume, candidates, g):
    return torch.empty_like(volume), torch.empty_like(candidates)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, grad):
    """On the card the backward kernel; on the CPU autograd of the plain
    version."""
    volume, candidates = ctx.saved_tensors
    if volume.device.type == "cpu":
        return kernels.plain_vjp(local_soft_argmin_plain,
                                 (volume, candidates), grad,
                                 ctx.needs_input_grad)
    return local_soft_argmin_bwd_op(volume, candidates, grad.contiguous())


local_soft_argmin_op.register_autograd(_backward, setup_context=_setup)


def local_soft_argmin(volume: torch.Tensor,
                      candidates: torch.Tensor) -> torch.Tensor:
    """Re-sample + softmax + expectation over the candidates: volume
    [B, H, W, D], candidates [B, H, W, S] -> disparity [B, H, W, 1], through
    the op ``stereoformer::local_soft_argmin``: CPU tensors take the plain
    version; CUDA tensors launch the kernel (and the backward kernel for the
    gradient) or raise."""
    return local_soft_argmin_op(volume, candidates)


local_soft_argmin.launches = 0
local_soft_argmin.backward_launches = 0


def fixed_local_cost_volume(volume: torch.Tensor, cur_disp: torch.Tensor,
                            radius: float, num_samples: int,
                            consider_valid: bool = False) -> torch.Tensor:
    """Fixed-radius refinement: the local soft-argmin over num_samples+1
    candidates in cur_disp -/+ radius. volume [B, H, W, D], cur_disp
    [B, H, W, 1] -> [B, H, W, 1]."""
    cands = make_candidates(cur_disp - radius, cur_disp + radius, cur_disp,
                            num_samples, volume.shape[-1],
                            consider_valid=consider_valid)
    return local_soft_argmin(volume, cands.contiguous())


def variance_local_cost_volume(volume: torch.Tensor, cur_disp: torch.Tensor,
                               gamma: float, num_samples: int,
                               consider_valid: bool = False) -> torch.Tensor:
    """Variance-scaled refinement: candidates in mu -/+ gamma * sigma, sigma
    the root variance of softmax(volume) around cur_disp = mu. With
    ``consider_valid`` a pixel whose upper bound passes its own column x of
    the volume's grid (upper > x: the match would leave the image) is
    invalid too; without it both bounds are clamped to [0, D - 1]."""
    B, H, W, D = volume.shape
    sigma = disparity_variance(torch.softmax(volume, dim=-1), cur_disp)
    lower = cur_disp - gamma * sigma
    upper = cur_disp + gamma * sigma
    if consider_valid:
        x = torch.arange(W, dtype=volume.dtype, device=volume.device)
        cands = make_candidates(lower, upper, cur_disp, num_samples, D,
                                extra_invalid=upper > x[:, None])
    else:
        # jnp.clip's half gradient at a tie, as make_candidates
        zero = lower.new_full((), 0.0)
        top = lower.new_full((), float(D - 1))
        lower = torch.minimum(torch.maximum(lower, zero), top)
        upper = torch.minimum(torch.maximum(upper, zero), top)
        steps = torch.arange(num_samples + 1, dtype=lower.dtype,
                             device=lower.device)
        cands = lower + steps * ((upper - lower) / num_samples)
    return local_soft_argmin(volume, cands.contiguous())
