"""CrossAttentionStereo, float32 or bf16: the epipolar cross-attention family.

Counterpart of ``stereoformer_tpu/models/cross_attention.py``: LowCNN's
siamese backbone and FPN to 1/8 (``SiameseStereo``); 1x1 projections
``proj_q`` (left), ``proj_k`` and ``proj_v`` (right); multi-head banded
attention over D = max_disp / 8 disparities (``ops.banded_attention``); the
score band (D x heads channels, disparity-major), the attended right feature
and the left feature fused into a D-channel volume by ``fuse1`` (1x1, ReLU)
and ``fuse2`` (3x3), three aggregation ResBlocks ``agg``; then soft-argmin
and LowCNN_gru's refinement: ``iters`` GRU steps (``local_cost_volume``),
each upsampled with its own convex mask, or bilinearly with
``upsample="simple"``. Its outputs follow LowCNN's contract.

``dtype=torch.bfloat16``, as the JAX model: the backbone, the projections,
``fuse1``, ``fuse2`` and ``agg`` compute in bf16; q, k and v are cast to
float32 for the banded attention, whose scores and blend stay float32 with
the left feature beside them, and the volume is float32 from ``agg`` on;
the GRU refinement is LowCNN's.

The JAX model has no reference checkpoint: the submodules are named after
the JAX tree where it names them (``proj_q`` ... ``fuse2``; ``agg.i`` for
``agg{i}``) and after LowCNN's where Flax numbers them (the backbone, and
``local_cost_volume`` for ``GRUUpdate_0``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import GRUUpdate, ResBlock
from ..nn.conv import Conv, check_dtype
from ..ops import banded_attention, soft_argmin
from .low_cnn import SiameseStereo

FEATURES, VALUE_DIM = 256, 128


class CrossAttentionStereo(SiameseStereo):
    def __init__(self, max_disp: int = 192, num_heads: int = 8,
                 qk_dim: int = 128, upsample: str = "convex",
                 num_samples: int = 20, gru_hidden: int = 32, dtype=None):
        super().__init__()
        if upsample not in ("convex", "simple"):
            raise ValueError(f"unknown upsample {upsample!r}")
        dt = check_dtype(dtype)
        self.upsample, self.num_heads = upsample, num_heads
        self.num_bins = D = max_disp // 8
        self._build_backbone(dt)
        self.proj_q = Conv(FEATURES, qk_dim, 1, dtype=dt)
        self.proj_k = Conv(FEATURES, qk_dim, 1, dtype=dt)
        self.proj_v = Conv(FEATURES, VALUE_DIM, 1, dtype=dt)
        self.fuse1 = Conv(D * num_heads + VALUE_DIM + FEATURES, 2 * D, 1,
                          dtype=dt)
        self.fuse2 = Conv(2 * D, D, 3, dtype=dt)
        self.agg = nn.ModuleList(ResBlock(D, D, dtype=dt) for _ in range(3))
        self.local_cost_volume = GRUUpdate(D, gru_hidden, num_samples,
                                           dtype=dt)

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                iters: int = 12) -> dict:
        """left, right: normalised images [B, H, W, 3], H and W multiples
        of 8. Returns {"disparities": ``iters`` of [B, H, W, 1],
        "disp_low": [B, H/8, W/8, 1]}."""
        B = left.shape[0]
        fused = self._features(left, right)
        feat_l, feat_r = fused[:B], fused[B:]

        def nhwc(x):
            return x.permute(0, 2, 3, 1).float().contiguous()

        # q, k and v are cast to float32 right after their bias add
        scores, attended = banded_attention(
            nhwc(self.proj_q.forward_f32(feat_l)),
            nhwc(self.proj_k.forward_f32(feat_r)),
            nhwc(self.proj_v.forward_f32(feat_r)), self.num_bins,
            self.num_heads)
        ctx = torch.cat([scores.flatten(3), attended, nhwc(feat_l)], dim=-1)
        v = self.fuse2(torch.relu(self.fuse1(ctx.permute(0, 3, 1, 2))))
        for block in self.agg:
            v = block(v)
        volume = v.permute(0, 2, 3, 1).float().contiguous()
        disp_low = soft_argmin(volume)[..., None]
        return {"disp_low": disp_low,
                "disparities": self._gru(volume, disp_low, left, right, None,
                                         iters)}
