"""Disparity upsampling (NHWC): learned convex, and simple bilinear.

Counterpart of ``stereoformer_tpu/ops/upsample.py`` (``upsample_convex``,
``upsample_convex8`` and ``upsample_simple8``). Its gradient is torch autograd's, the same VJP as the
JAX package's hand-written one (``_upsample_convex_bwd``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .resize import resize_bilinear


def neighborhood9(x: torch.Tensor) -> torch.Tensor:
    """The zero-padded 3x3 neighbourhood of x [B, H, W, 1] -> [B, H, W, 9],
    k = ky*3 + kx (F.unfold's order)."""
    H, W = x.shape[1:3]
    p = F.pad(x[..., 0], (1, 1, 1, 1))
    return torch.stack(
        [p[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)],
        dim=-1)


def upsample_convex(disp: torch.Tensor, mask: torch.Tensor,
                    factor: int) -> torch.Tensor:
    """Learned convex ``factor``x upsample.

    disp [B, H, W, 1] in coarse pixels (scaled by ``factor`` before
    blending); mask [B, H, W, 9*factor^2] logits laid out (k, dy, dx) =
    k*factor^2 + dy*factor + dx. The 9 neighbours are softmaxed per fine
    sub-pixel. Returns [B, factor*H, factor*W, 1]."""
    B, H, W, _ = disp.shape
    f = factor
    probs = torch.softmax(mask.reshape(B, H, W, 9, f * f), dim=3)
    nbr = neighborhood9(float(f) * disp)                    # [B, H, W, 9]
    up = (probs * nbr[..., None]).sum(3)                    # [B, H, W, f*f]
    up = up.reshape(B, H, W, f, f).permute(0, 1, 3, 2, 4)   # [B, H, f, W, f]
    return up.reshape(B, f * H, f * W, 1)


def upsample_convex8(disp: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Learned convex 8x upsample (mask [B, H, W, 576])."""
    return upsample_convex(disp, mask, 8)


def upsample_simple8(disp: torch.Tensor) -> torch.Tensor:
    """8x bilinear upsample with align_corners=True, values scaled by 8:
    disp [B, H, W, 1] -> [B, 8H, 8W, 1]."""
    H, W = disp.shape[1:3]
    return 8.0 * resize_bilinear(disp, (8 * H, 8 * W), align_corners=True)
