"""All-pairs 1D (epipolar) correlation pyramid and windowed lookup, for
RAFT-Stereo (NHWC features).

Counterpart of ``stereoformer_tpu/ops/corr1d.py`` (``allpairs_corr1d``,
``corr_pyramid``, ``corr_lookup`` with the flat gather sampler
``_sample_last_gather``). The JAX package's eval path reads the pyramid
through a blocked layout (``corr_block_cache``), a TPU arrangement of the
same values; the lookup here gathers from the pyramid itself.
"""

from __future__ import annotations

import math

import torch


def allpairs_corr1d(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """fmap1, fmap2 [B, H, W, C] -> corr [B, H, W, W2], one product per row,
    scaled by 1/sqrt(C)."""
    corr = torch.matmul(fmap1, fmap2.transpose(-1, -2))
    return corr / math.sqrt(fmap1.shape[-1])


def corr_pyramid(corr: torch.Tensor, num_levels: int) -> list:
    """Average-pool the last axis by 2 per level -> [corr_0, ..., corr_{L-1}]
    (an odd last column is dropped)."""
    out = [corr]
    for _ in range(num_levels - 1):
        W2 = out[-1].shape[-1] // 2
        x = out[-1][..., :2 * W2]
        out.append(x.reshape(*x.shape[:-1], W2, 2).mean(-1))
    return out


def _sample_last_gather(x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Linear sample of the last axis of x [..., W] at coords [..., S], zero
    outside [0, W - 1]."""
    W = x.shape[-1]
    x0 = torch.floor(coords)
    t = coords - x0
    w0 = ((x0 >= 0) & (x0 <= W - 1)).to(coords.dtype)
    w1 = ((x0 + 1 >= 0) & (x0 + 1 <= W - 1)).to(coords.dtype)
    # clamped before the cast; a NaN coordinate gathers index 0 (its weight
    # is NaN anyway) rather than an index out of range
    i0 = x0.clamp(0, W - 1).nan_to_num(0.0).long()
    i1 = (x0 + 1).clamp(0, W - 1).nan_to_num(0.0).long()
    v0 = torch.gather(x, -1, i0)
    v1 = torch.gather(x, -1, i1)
    return v0 * (1 - t) * w0 + v1 * t * w1


def corr_lookup(pyramid, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Sample a +-radius window around ``coords`` [B, H, W] (the match's
    x-position in level-0 units) at every level -> [B, H, W, L*(2r+1)],
    level-major."""
    offsets = torch.arange(-radius, radius + 1, dtype=coords.dtype,
                           device=coords.device)
    outs = []
    for lvl, corr in enumerate(pyramid):
        centre = coords / (2 ** lvl)
        outs.append(_sample_last_gather(corr, centre[..., None] + offsets))
    return torch.cat(outs, dim=-1)
