"""LowCNN, float32: the GRU refinement (``LowCNN_gru``) and the learned
bounds (``LowCNN_dynamic``, ``LowCNN_dynamic_supervised``).

Counterpart of ``stereoformer_tpu/models/low_cnn.py::LowCNN`` with
``refinement`` one of "gru", "learned" and "learned_supervised": a siamese
backbone and FPN to 1/8, the 24-bin correlation volume, three aggregation
ResBlocks and soft-argmin, then

- "gru": ``iters`` GRU refinement steps, each convex-upsampled 8x with its
  own mask;
- "learned" / "learned_supervised": one learned-bounds refinement
  (``nn/update.py::LearnedBounds``, its offset net running a deformable
  conv) from the full-resolution images, the bounds absolute or around
  the current disparity; ``disp_low`` and the refined disparity are both
  upsampled with one convex mask from the left feature
  (``ConvAffinityUpsample``). ``iters`` is ignored.

Submodule names follow the reference ``state_dict`` keys
(``correlation_aggreagtion`` is the reference's spelling), so reference
checkpoints load as they are.

``model.train()`` normalises with batch statistics and moves the running
ones (``nn/norm.py``); gradients flow through every refinement step, the
current disparity included, as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import ConvLReLU, FPNFusion, GRUUpdate, LearnedBounds, ResBlock
from ..nn.conv import Conv
from ..ops import (
    correlation_volume,
    resize_bilinear,
    soft_argmin,
    upsample_convex8,
)

REFINEMENTS = ("gru", "learned", "learned_supervised")


class ConvAffinityUpsample(nn.Module):
    """conv3x3-ReLU-conv1x1 -> 8*8*9 convex-upsample mask logits, x0.25;
    keys ``upsample_mask.0`` and ``upsample_mask.2``."""

    def __init__(self, in_channels: int = 256, hidden: int = 128):
        super().__init__()
        self.upsample_mask = nn.Sequential(Conv(in_channels, hidden, 3),
                                           nn.ReLU(),
                                           Conv(hidden, 8 * 8 * 9, 1))

    def forward(self, feature):
        """feature [B, C, H, W] -> mask [B, H, W, 576]."""
        return 0.25 * self.upsample_mask(feature).permute(0, 2, 3, 1)


class LowCNN(nn.Module):
    def __init__(self, max_disp: int = 192, refinement: str = "gru",
                 num_samples: int = 20, gru_hidden: int = 32):
        super().__init__()
        if refinement not in REFINEMENTS:
            raise NotImplementedError(
                f"refinement {refinement!r} is not yet ported (the rest of "
                f"the LowCNN family comes in a later slice); ported: "
                f"{REFINEMENTS}")
        self.refinement = refinement
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
        if refinement == "gru":
            self.local_cost_volume = GRUUpdate(self.num_bins, gru_hidden,
                                               num_samples)
        else:
            self.upsample_mask = ConvAffinityUpsample()
            self.local_cost_volume = LearnedBounds(
                self.num_bins, num_samples,
                relative=refinement == "learned_supervised")

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                iters: int = 12) -> dict:
        """left, right: normalised images [B, H, W, 3], H and W multiples
        of 8.

        Returns {"disparities": [B, H, W, 1] each (``iters`` of them for
        "gru", [initial, refined] for the learned bounds),
        "disp_low": [B, H/8, W/8, 1]}, and for "learned_supervised"
        "bounds": (lower, upper) [B, H/8, W/8, 1] each."""
        B = left.shape[0]
        # one backbone pass over the stacked pair, as the JAX model does
        x = torch.cat([left, right], dim=0).permute(0, 3, 1, 2)
        x = self.conv3(self.conv2(self.conv1(x)))
        f8 = self.downsample1(x)
        f16 = self.downsample2(f8)
        f32 = self.downsample3(f16)
        fused = self.feature_concated([f32, f16, f8])
        feats = fused.permute(0, 2, 3, 1)
        volume = correlation_volume(feats[:B].contiguous(),
                                    feats[B:].contiguous(), self.num_bins)

        v = volume.permute(0, 3, 1, 2)
        for block in self.correlation_aggreagtion:
            v = block(v)
        volume = v.permute(0, 2, 3, 1).float().contiguous()
        disp_low = soft_argmin(volume)[..., None]
        out = {"disp_low": disp_low}

        if self.refinement != "gru":
            mask = self.upsample_mask(fused[:B])
            refined, bounds = self.local_cost_volume(
                volume, disp_low, left, right,
                consider_valid=self.refinement == "learned")
            if self.refinement == "learned_supervised":
                out["bounds"] = bounds
            out["disparities"] = [upsample_convex8(disp_low, mask),
                                  upsample_convex8(refined, mask)]
            return out

        H8, W8 = volume.shape[1:3]
        left8 = resize_bilinear(left, (H8, W8), align_corners=False)
        right8 = resize_bilinear(right, (H8, W8), align_corners=False)
        prob = torch.softmax(volume, dim=-1)   # loop-invariant
        disp, hidden, preds = disp_low, None, []
        for _ in range(iters):
            disp, hidden, mask = self.local_cost_volume(
                volume, disp, left8, right8, hidden, prob)
            preds.append(upsample_convex8(disp, mask))
        out["disparities"] = preds
        return out
