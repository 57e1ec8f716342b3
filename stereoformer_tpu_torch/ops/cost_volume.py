"""Correlation cost volume [B, H, W, D] (NHWC features, D innermost).

Counterpart of ``stereoformer_tpu/ops/cost_volume.py::correlation_volume``
and of its Pallas kernel ``ops/pallas/corr_band.py::corr_band``:

    out[b,h,w,d] = mean_c left[b,h,w,c] * right[b,h,w-d,c],   0 where w < d.

``correlation_volume`` takes the plain version for CPU tensors and launches
the CUDA kernel ``csrc/corr_band.cu`` for CUDA tensors, counting launches in
``correlation_volume.launches``. Its gradient on the GPU waits for the
training slice's backward kernel: the backward raises.
"""

from __future__ import annotations

import torch

from .. import kernels


def correlation_volume_plain(left: torch.Tensor, right: torch.Tensor,
                             max_disp: int) -> torch.Tensor:
    """The plain version: D shifted products, each averaged over C."""
    B, H, W, _ = left.shape
    out = left.new_zeros((B, H, W, max_disp))
    for d in range(min(max_disp, W)):
        out[:, :, d:, d] = (left[:, :, d:, :] * right[:, :, : W - d, :]).mean(-1)
    return out


class _CorrBand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, left, right, max_disp):
        kernels.check_inputs("corr_band", left, right)
        if left.dim() != 4 or left.shape != right.shape:
            raise ValueError(
                f"corr_band: left and right must be [B, H, W, C] of one "
                f"shape, got {tuple(left.shape)} and {tuple(right.shape)}")
        B, H, W, C = left.shape
        if C % 4 or not 0 < max_disp <= 64:
            raise ValueError(
                f"corr_band: the kernel takes C a multiple of 4 and "
                f"0 < max_disp <= 64, got C={C}, max_disp={max_disp}")
        out = torch.empty((B, H, W, max_disp), dtype=torch.float32,
                          device=left.device)
        kernels.launch("corr_band", left.device, left.data_ptr(),
                       right.data_ptr(), out.data_ptr(), B, H, W, C, max_disp)
        correlation_volume.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "backward kernel lands with the training slice")


def correlation_volume(left: torch.Tensor, right: torch.Tensor,
                       max_disp: int) -> torch.Tensor:
    """Correlation volume of NHWC features left, right [B, H, W, C] ->
    [B, H, W, max_disp]. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    if left.device.type == "cpu" and right.device.type == "cpu":
        return correlation_volume_plain(left, right, max_disp)
    return _CorrBand.apply(left, right, max_disp)


correlation_volume.launches = 0
