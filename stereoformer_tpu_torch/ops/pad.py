"""Input padding to a multiple of 8, Gaussian blur and forward flow
interpolation (NHWC).

Counterpart of ``stereoformer_tpu/ops/pad.py`` (``InputPadder``,
``gauss_blur``, ``forward_interpolate``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class InputPadder:
    """Edge-pad NHWC images so H and W are multiples of ``divisor``: the
    width padding split left/right, the height padding all at the bottom
    (``mode="default"``) or split top/bottom (``mode="sintel"``)."""

    def __init__(self, shape, divisor: int = 8, mode: str = "default"):
        ht, wd = shape[-3], shape[-2]
        pad_ht = (((ht // divisor) + 1) * divisor - ht) % divisor
        pad_wd = (((wd // divisor) + 1) * divisor - wd) % divisor
        if mode == "sintel":
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2,
                         pad_ht - pad_ht // 2)
        else:
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)

    def pad(self, *inputs: torch.Tensor):
        out = [F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate")
               .permute(0, 2, 3, 1) for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        H, W = x.shape[-3], x.shape[-2]
        return x[..., t: H - b, l: W - r, :]


def gauss_blur(x: torch.Tensor, kernel_size: int = 5,
               sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur of NHWC images: a depthwise 1 x k conv, then
    a depthwise k x 1 conv, zero padding, the float32 kernel normalised to
    sum 1."""
    r = kernel_size // 2
    g = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    g = torch.from_numpy((g / g.sum()).astype(np.float32)).to(x.device,
                                                              x.dtype)
    C = x.shape[-1]
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, g.view(1, 1, 1, -1).expand(C, 1, 1, kernel_size),
                 padding=(0, r), groups=C)
    y = F.conv2d(y, g.view(1, 1, -1, 1).expand(C, 1, kernel_size, 1),
                 padding=(r, 0), groups=C)
    return y.permute(0, 2, 3, 1)


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Forward-warp a [H, W, 2] flow field (numpy, on the host) to the next
    frame: each pixel's flow is splatted to its rounded target, targets
    that several pixels reach take their mean, the rest stay 0."""
    H, W = flow.shape[:2]
    dx, dy = flow[..., 0], flow[..., 1]
    y0, x0 = np.mgrid[:H, :W]
    x1 = np.round(x0 + dx).astype(np.int64)
    y1 = np.round(y0 + dy).astype(np.int64)
    ok = (x1 >= 0) & (x1 < W) & (y1 >= 0) & (y1 < H)
    out = np.zeros_like(flow)
    cnt = np.zeros((H, W, 1), np.float32)
    np.add.at(out, (y1[ok], x1[ok]), flow[ok])
    np.add.at(cnt, (y1[ok], x1[ok]), 1.0)
    filled = cnt[..., 0] > 0
    out[filled] /= cnt[filled]
    return out
