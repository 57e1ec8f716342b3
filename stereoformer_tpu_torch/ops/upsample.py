"""Learned convex 8x disparity upsampling (NHWC).

Counterpart of ``stereoformer_tpu/ops/upsample.py::upsample_convex8``. Its
gradient is torch autograd's, the same VJP as the JAX package's
hand-written one (``_upsample_convex_bwd``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def neighborhood9(x: torch.Tensor) -> torch.Tensor:
    """The zero-padded 3x3 neighbourhood of x [B, H, W, 1] -> [B, H, W, 9],
    k = ky*3 + kx (F.unfold's order)."""
    H, W = x.shape[1:3]
    p = F.pad(x[..., 0], (1, 1, 1, 1))
    return torch.stack(
        [p[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)],
        dim=-1)


def upsample_convex8(disp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Learned convex 8x upsample.

    disp [B, H, W, 1] in coarse pixels (scaled by 8 before blending); mask
    [B, H, W, 576] logits laid out (k, dy, dx) = k*64 + dy*8 + dx. The 9
    neighbours are softmaxed per fine sub-pixel. Returns [B, 8H, 8W, 1]."""
    B, H, W, _ = disp.shape
    probs = torch.softmax(mask.reshape(B, H, W, 9, 64), dim=3)
    nbr = neighborhood9(8.0 * disp)                         # [B, H, W, 9]
    up = (probs * nbr[..., None]).sum(3)                    # [B, H, W, 64]
    up = up.reshape(B, H, W, 8, 8).permute(0, 1, 3, 2, 4)   # [B, H, 8, W, 8]
    return up.reshape(B, 8 * H, 8 * W, 1)
