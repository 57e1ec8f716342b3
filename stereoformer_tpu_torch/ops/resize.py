"""Bilinear resize with explicit ``align_corners`` semantics (NHWC).

Counterpart of ``stereoformer_tpu/ops/resize.py``: each axis is resized by a
static interpolation matrix built in numpy, with the source coordinate
clipped to the input for ``align_corners=False``.
"""

from __future__ import annotations

import numpy as np
import torch


def _interp_matrix(out_size: int, in_size: int,
                   align_corners: bool) -> np.ndarray:
    """M [out, in] with out = M @ x along the resized axis."""
    out = np.arange(out_size, dtype=np.float64)
    if align_corners:
        coords = (np.zeros(1) if out_size == 1
                  else out * ((in_size - 1) / (out_size - 1)))
    else:
        coords = np.clip((out + 0.5) * (in_size / out_size) - 0.5, 0.0,
                         in_size - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.clip(lo + 1, 0, in_size - 1)
    lo = np.clip(lo, 0, in_size - 1)
    t = coords - lo
    M = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(M, (rows, lo), 1.0 - t)
    np.add.at(M, (rows, hi), t)
    return M


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False
                    ) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` [..., H, W, C] to (H', W') = size."""
    H, W = size
    Mh = torch.from_numpy(_interp_matrix(H, x.shape[-3], align_corners))
    Mw = torch.from_numpy(_interp_matrix(W, x.shape[-2], align_corners))
    Mh = Mh.to(device=x.device, dtype=x.dtype)
    Mw = Mw.to(device=x.device, dtype=x.dtype)
    x = torch.einsum("oh,...hwc->...owc", Mh, x)
    return torch.einsum("ow,...hwc->...hoc", Mw, x)
