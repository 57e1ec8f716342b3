"""Local cost-volume refinement: candidates, hat re-sample, local soft-argmin.

Counterpart of ``stereoformer_tpu/ops/local_volume.py`` (``make_candidates``
with ``consider_valid=True``, ``resample_volume_hat``, ``local_soft_argmin``)
and of its Pallas kernel
``ops/pallas/local_refine.py::fused_local_soft_argmin``.

``local_soft_argmin`` takes the plain version for CPU tensors and launches
the CUDA kernel ``csrc/local_soft_argmin.cu`` for CUDA tensors, counting
launches in ``local_soft_argmin.launches``. Its gradient on the GPU waits for
the training slice's backward kernel: the backward raises.
"""

from __future__ import annotations

import torch

from .. import kernels


def make_candidates(lower: torch.Tensor, upper: torch.Tensor,
                    cur_disp: torch.Tensor, num_samples: int,
                    max_disp: int) -> torch.Tensor:
    """S+1 = num_samples+1 uniform candidates in [lower, upper] per pixel.

    lower, upper, cur_disp: [B, H, W, 1] -> [B, H, W, S+1]. A pixel whose
    range leaves [0, max_disp - 1) (lower < 0 or upper >= max_disp - 1, with
    max_disp the volume's D) collapses every candidate to cur_disp."""
    steps = torch.arange(num_samples + 1, dtype=lower.dtype,
                         device=lower.device)
    invalid = ((lower < 0) | (upper >= max_disp - 1)).to(lower.dtype)
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


class _LocalSoftArgmin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, volume, candidates):
        kernels.check_inputs("local_soft_argmin", volume, candidates)
        if (volume.dim() != 4 or candidates.dim() != 4
                or volume.shape[:3] != candidates.shape[:3]):
            raise ValueError(
                f"local_soft_argmin: volume [B, H, W, D] and candidates "
                f"[B, H, W, S] must share B, H, W, got {tuple(volume.shape)} "
                f"and {tuple(candidates.shape)}")
        B, H, W, D = volume.shape
        S = candidates.shape[-1]
        if S > 32 or D > 48:
            raise ValueError(
                f"local_soft_argmin: the kernel takes S <= 32 and D <= 48, "
                f"got S={S}, D={D}")
        out = torch.empty((B, H, W, 1), dtype=torch.float32,
                          device=volume.device)
        kernels.launch("local_soft_argmin", volume.device, volume.data_ptr(),
                       candidates.data_ptr(), out.data_ptr(), B * H * W, D, S)
        local_soft_argmin.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "backward kernel lands with the training slice")


def local_soft_argmin(volume: torch.Tensor,
                      candidates: torch.Tensor) -> torch.Tensor:
    """Re-sample + softmax + expectation over the candidates: volume
    [B, H, W, D], candidates [B, H, W, S] -> disparity [B, H, W, 1]. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if volume.device.type == "cpu" and candidates.device.type == "cpu":
        return local_soft_argmin_plain(volume, candidates)
    return _LocalSoftArgmin.apply(volume, candidates)


local_soft_argmin.launches = 0
