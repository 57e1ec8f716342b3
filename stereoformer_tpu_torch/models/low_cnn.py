"""LowCNN with GRU refinement (``LowCNN_gru``), float32.

Counterpart of ``stereoformer_tpu/models/low_cnn.py::LowCNN`` with
``refinement="gru"``: a siamese backbone and FPN to 1/8, the 24-bin
correlation volume, three aggregation ResBlocks, soft-argmin, ``iters`` GRU
refinement steps and the convex 8x upsample. Submodule names follow the
reference ``state_dict`` keys (``correlation_aggreagtion`` is the
reference's spelling), so reference checkpoints load as they are.

``model.train()`` normalises with batch statistics and moves the running
ones (``nn/norm.py``); gradients flow through every GRU step, the current
disparity included, as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import ConvLReLU, FPNFusion, GRUUpdate, ResBlock
from ..ops import (
    correlation_volume,
    resize_bilinear,
    soft_argmin,
    upsample_convex8,
)


class LowCNN(nn.Module):
    def __init__(self, max_disp: int = 192, num_samples: int = 20,
                 gru_hidden: int = 32):
        super().__init__()
        self.num_bins = max_disp // 8
        self.conv1 = ConvLReLU(3, 64, 7, 2)
        self.conv2 = ResBlock(64, 128, stride=2)
        self.conv3 = ResBlock(128, 256, stride=2)
        self.downsample1 = ResBlock(256, 256)
        self.downsample2 = ResBlock(256, 512, stride=2)
        self.downsample3 = ResBlock(512, 512, stride=2)
        self.feature_concated = FPNFusion((512, 512, 256))
        self.correlation_aggreagtion = nn.ModuleList(
            ResBlock(self.num_bins, self.num_bins) for _ in range(3))
        self.local_cost_volume = GRUUpdate(self.num_bins, gru_hidden,
                                           num_samples)

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                iters: int = 12) -> dict:
        """left, right: normalised images [B, H, W, 3], H and W multiples
        of 8.

        Returns {"disparities": iters x [B, H, W, 1],
                 "disp_low": [B, H/8, W/8, 1]}."""
        B = left.shape[0]
        # one backbone pass over the stacked pair, as the JAX model does
        x = torch.cat([left, right], dim=0).permute(0, 3, 1, 2)
        x = self.conv3(self.conv2(self.conv1(x)))
        f8 = self.downsample1(x)
        f16 = self.downsample2(f8)
        f32 = self.downsample3(f16)
        feats = self.feature_concated([f32, f16, f8]).permute(0, 2, 3, 1)
        volume = correlation_volume(feats[:B].contiguous(),
                                    feats[B:].contiguous(), self.num_bins)

        v = volume.permute(0, 3, 1, 2)
        for block in self.correlation_aggreagtion:
            v = block(v)
        volume = v.permute(0, 2, 3, 1).float().contiguous()
        disp_low = soft_argmin(volume)[..., None]

        H8, W8 = volume.shape[1:3]
        left8 = resize_bilinear(left, (H8, W8), align_corners=False)
        right8 = resize_bilinear(right, (H8, W8), align_corners=False)
        prob = torch.softmax(volume, dim=-1)   # loop-invariant
        disp, hidden, preds = disp_low, None, []
        for _ in range(iters):
            disp, hidden, mask = self.local_cost_volume(
                volume, disp, left8, right8, hidden, prob)
            preds.append(upsample_convex8(disp, mask))
        return {"disparities": preds, "disp_low": disp_low}
