"""Row gather: out[i, c] = img[idx[i, c], c] (``take_along_axis`` on axis 0).

Counterpart of the Pallas kernel of ``scripts/_gather_probe.py`` (``main``,
body ``kernel``). ``take_rows`` takes the plain version (``take_rows_plain``)
for CPU tensors and launches the CUDA kernel ``csrc/row_gather.cu`` for CUDA
tensors, counting launches in ``take_rows.launches``. On either it refuses an
index outside [0, N) first.
"""

from __future__ import annotations

import torch

from .. import kernels


def _check(img: torch.Tensor, idx: torch.Tensor) -> None:
    if img.dim() != 2 or idx.dim() != 2 or idx.shape[1] != img.shape[1]:
        raise ValueError(
            f"take_rows: img must be [N, C] and idx [M, C], got "
            f"{tuple(img.shape)} and {tuple(idx.shape)}")
    if idx.dtype.is_floating_point or idx.dtype.is_complex:
        raise TypeError(f"take_rows: idx must be integer, got {idx.dtype}")
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= img.shape[0]:
            raise IndexError(
                f"take_rows: indices must lie in [0, {img.shape[0]}), got "
                f"{lo}..{hi}")


def take_rows_plain(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain version: the flat index idx * C + c into img's flat view
    (``take_rows`` checks the indices before it)."""
    C = img.shape[1]
    flat = idx.long() * C + torch.arange(C, device=idx.device)
    return img.reshape(-1)[flat]


def take_rows(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """img [N, C], idx [M, C] integer -> out [M, C], out[i, c] =
    img[idx[i, c], c]. CPU tensors take the plain version; CUDA tensors
    (img float32, idx int32, both contiguous) launch the kernel or raise."""
    if img.device.type == "cpu" and idx.device.type == "cpu":
        _check(img, idx)
        return take_rows_plain(img, idx)
    kernels.check_inputs("row_gather", img)
    if idx.device != img.device or idx.dtype != torch.int32 \
            or not idx.is_contiguous():
        raise ValueError(
            f"row_gather: idx must be a contiguous int32 tensor on "
            f"{img.device}, got {idx.dtype} on {idx.device}")
    _check(img, idx)
    out = img.new_empty(idx.shape)
    kernels.launch("row_gather", img.device, img.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), img.shape[0], idx.shape[0], img.shape[1])
    take_rows.launches += 1
    return out


take_rows.launches = 0
