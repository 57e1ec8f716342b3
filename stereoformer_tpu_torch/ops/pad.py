"""Input padding to a multiple of 8 (NHWC).

Counterpart of ``stereoformer_tpu/ops/pad.py::InputPadder``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class InputPadder:
    """Edge-pad NHWC images so H and W are multiples of ``divisor``: all
    height padding at the bottom, the width padding split left/right."""

    def __init__(self, shape, divisor: int = 8):
        ht, wd = shape[-3], shape[-2]
        pad_ht = (((ht // divisor) + 1) * divisor - ht) % divisor
        pad_wd = (((wd // divisor) + 1) * divisor - wd) % divisor
        self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)

    def pad(self, *inputs: torch.Tensor):
        out = [F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate")
               .permute(0, 2, 3, 1) for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        H, W = x.shape[-3], x.shape[-2]
        return x[..., t: H - b, l: W - r, :]
