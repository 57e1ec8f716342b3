"""Banded epipolar cross-attention (NHWC).

Counterpart of ``stereoformer_tpu/ops/attention.py``. For rectified stereo
left pixel (h, w) can only match right pixels (h, w - d), d in [0, D): the
scores are the group-wise correlation band (``gwc_volume``) rescaled to
dot / sqrt(dh), and the attended value is a D-term shifted blend of v, so
no [W, W] attention matrix is formed. Plain PyTorch: the JAX package
computes both in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cost_volume import gwc_volume


def banded_attention_scores(q: torch.Tensor, k: torch.Tensor, max_disp: int,
                            num_heads: int) -> torch.Tensor:
    """Per-head scaled dot products <q_head[w], k_head[w - d]> / sqrt(dh),
    0 where w < d. q (left), k (right) [B, H, W, C], C a multiple of
    ``num_heads`` -> [B, H, W, D, heads]."""
    dh = q.shape[-1] // num_heads
    # gwc_volume takes the mean over the head's channels: times dh / sqrt(dh)
    return gwc_volume(q, k, max_disp, num_heads) * (dh / dh ** 0.5)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     max_disp: int, num_heads: int):
    """Banded cross-attention -> (scores [B, H, W, D, heads], attended
    [B, H, W, Cv]).

    attended[w] = sum_d pbar[w, d] * v[w - d], with pbar the head mean of
    the softmax over D of the scores; out-of-band (w < d) scores are -inf
    before the softmax and their probabilities 0 after it. Column d = 0 is
    always in band, so no row is all -inf and the gradient has no NaN."""
    W = v.shape[2]
    scores = banded_attention_scores(q, k, max_disp, num_heads)
    w_idx = torch.arange(W, device=v.device)[:, None, None]
    d_idx = torch.arange(max_disp, device=v.device)[None, :, None]
    valid = w_idx >= d_idx                                   # [W, D, 1]
    probs = torch.softmax(scores.masked_fill(~valid, float("-inf")), dim=3)
    pbar = probs.masked_fill(~valid, 0.0).mean(-1)            # [B, H, W, D]
    attended = pbar[..., 0:1] * v
    for d in range(1, min(max_disp, W)):
        attended = attended + pbar[..., d:d + 1] * F.pad(
            v[:, :, :W - d], (0, 0, d, 0))
    return scores, attended
