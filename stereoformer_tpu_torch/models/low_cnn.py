"""LowCNN, float32 or bf16: every refinement of the family.

Counterpart of ``stereoformer_tpu/models/low_cnn.py::LowCNN``: a siamese
backbone and FPN to 1/8, a 24-bin cost volume (``cost_volume=
"correlation"``, or "concat": the [B, H, W, D, 2C] concat volume projected
to one score per bin by ``concat_proj1``, ReLU and ``concat_proj2``), three
aggregation ResBlocks and soft-argmin, then by ``refinement``:

- "none" (``LowCNN_simple``): [disp_low] upsampled;
- "fixed" (``LowCNN``) and "variance" (``LowCNN_ada``): one local
  soft-argmin in disp_low -/+ ``radius``, or -/+ ``gamma`` times the root
  variance of the volume's softmax -> [disp_low, refined] upsampled;
- "gru" (``LowCNN_gru``) and "gru_feature" (``LowCNN_gru2``, its GRU also
  reading the encoded left feature): ``iters`` GRU refinement steps, each
  upsampled with its own mask;
- "learned" / "learned_supervised" (``LowCNN_dynamic``,
  ``LowCNN_dynamic_supervised``): one learned-bounds refinement
  (``nn/update.py::LearnedBounds``, its offset net running a deformable
  conv) from the full-resolution images, the bounds absolute or around
  the current disparity -> [disp_low, refined] upsampled.

``upsample="convex"`` takes the learned convex 8x upsample: the GRU step's
own mask, or for the other refinements one mask from the left feature
(``ConvAffinityUpsample``, built only then); "simple" the bilinear one
(the GRU step's mask head is then built, as in JAX, but unread). The
non-GRU refinements ignore ``iters``.

Submodule names follow the reference ``state_dict`` keys
(``correlation_aggreagtion`` is the reference's spelling), so reference
checkpoints load as they are; the modules the reference keys do not name
are named after the JAX modules (``concat_proj1``, ``concat_proj2``,
``feature_encode``).

``dtype=torch.bfloat16`` is the JAX model's deployment dtype: the
parameters stay float32 and are cast at each op (``nn/conv.py``); the
images are cast before ``conv1``; the backbone, the FPN, the volume (the
correlation summed in float32 and rounded once, or the concat volume's
projections) and the aggregation ResBlocks compute in bf16; from the
aggregated volume on (soft-argmin, softmax, candidates, the local
soft-argmin) everything is float32, except the GRU step's convs and hidden
state and ``ConvAffinityUpsample``'s convs, which are bf16 with float32
outputs. The learned bounds run in float32, as JAX runs them.

``model.train()`` normalises with batch statistics and moves the running
ones (``nn/norm.py``); gradients flow through every refinement step, the
current disparity included, as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import ConvLReLU, FPNFusion, GRUUpdate, LearnedBounds, ResBlock
from ..nn.conv import Conv, Linear, check_dtype
from ..ops import (
    concat_volume,
    correlation_volume,
    fixed_local_cost_volume,
    resize_bilinear,
    soft_argmin,
    upsample_convex8,
    upsample_simple8,
    variance_local_cost_volume,
)

REFINEMENTS = ("none", "fixed", "variance", "gru", "gru_feature", "learned",
               "learned_supervised")


class ConvAffinityUpsample(nn.Module):
    """conv3x3-ReLU-conv1x1 -> 8*8*9 convex-upsample mask logits, x0.25;
    keys ``upsample_mask.0`` and ``upsample_mask.2``."""

    def __init__(self, in_channels: int = 256, hidden: int = 128,
                 dtype=None):
        super().__init__()
        self.upsample_mask = nn.Sequential(
            Conv(in_channels, hidden, 3, dtype=dtype), nn.ReLU(),
            Conv(hidden, 8 * 8 * 9, 1, dtype=dtype))

    def forward(self, feature):
        """feature [B, C, H, W] -> mask [B, H, W, 576], float32."""
        conv1, relu, conv2 = self.upsample_mask
        return 0.25 * conv2.forward_f32(relu(conv1(feature))).permute(
            0, 2, 3, 1)


class SiameseStereo(nn.Module):
    """What LowCNN and CrossAttentionStereo share: the siamese backbone and
    FPN to 1/8 (``conv1`` ... ``feature_concated``, the reference's names),
    run once over the stacked pair so that train-mode BatchNorm statistics
    span both images, as in the JAX models; the GRU refinement loop over
    ``local_cost_volume``; and the 8x upsample picked by ``upsample``."""

    def _build_backbone(self, dtype):
        self.compute_dtype = dtype
        self.conv1 = ConvLReLU(3, 64, 7, 2, dtype=dtype)
        self.conv2 = ResBlock(64, 128, stride=2, dtype=dtype)
        self.conv3 = ResBlock(128, 256, stride=2, dtype=dtype)
        self.downsample1 = ResBlock(256, 256, dtype=dtype)
        self.downsample2 = ResBlock(256, 512, stride=2, dtype=dtype)
        self.downsample3 = ResBlock(512, 512, stride=2, dtype=dtype)
        self.feature_concated = FPNFusion((512, 512, 256), dtype=dtype)

    def _features(self, left: torch.Tensor,
                  right: torch.Tensor) -> torch.Tensor:
        """left, right [B, H, W, 3] -> the fused features of both,
        [2B, 256, H/8, W/8], the left images' first, in the compute
        dtype."""
        x = torch.cat([left, right], dim=0).permute(0, 3, 1, 2)
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = self.conv3(self.conv2(self.conv1(x)))
        f8 = self.downsample1(x)
        f16 = self.downsample2(f8)
        f32 = self.downsample3(f16)
        return self.feature_concated([f32, f16, f8])

    def _up(self, disp, mask):
        if self.upsample == "convex":
            return upsample_convex8(disp, mask)
        return upsample_simple8(disp)

    def _gru(self, volume, disp_low, left, right, left_feature, iters):
        """The GRU refinements' ``iters`` upsampled disparities;
        ``left_feature`` [B, 256, H/8, W/8] for "gru_feature", else None."""
        H8, W8 = volume.shape[1:3]
        left8 = resize_bilinear(left, (H8, W8), align_corners=False)
        right8 = resize_bilinear(right, (H8, W8), align_corners=False)
        prob = torch.softmax(volume, dim=-1)   # loop-invariant
        disp, hidden, preds = disp_low, None, []
        for _ in range(iters):
            disp, hidden, mask = self.local_cost_volume(
                volume, disp, left8, right8, hidden, prob, left_feature)
            preds.append(self._up(disp, mask))
        return preds


class LowCNN(SiameseStereo):
    def __init__(self, max_disp: int = 192, refinement: str = "gru",
                 upsample: str = "convex", cost_volume: str = "correlation",
                 num_samples: int = 20, gru_hidden: int = 32,
                 radius: float = 2.0, gamma: float = 1.0, dtype=None,
                 loop: str = "unroll", scan_unroll: int = 1):
        # scan_unroll: the JAX model's lax.scan unroll factor, read only
        # under loop="scan"; accepted and unused under "unroll"
        super().__init__()
        if refinement not in REFINEMENTS:
            raise ValueError(f"unknown refinement {refinement!r}; one of "
                             f"{REFINEMENTS}")
        if upsample not in ("convex", "simple"):
            raise ValueError(f"unknown upsample {upsample!r}")
        if cost_volume not in ("correlation", "concat", "concated"):
            raise ValueError(f"unknown cost_volume {cost_volume!r}")
        if loop != "unroll":
            raise NotImplementedError(
                f"loop={loop!r} is not ported: it is the JAX package's "
                f"compile device; the port's GRU loop is always unrolled")
        dtype = check_dtype(dtype)
        self.refinement, self.upsample = refinement, upsample
        self.concat = cost_volume != "correlation"
        self.num_samples, self.radius, self.gamma = num_samples, radius, gamma
        self.num_bins = max_disp // 8
        self._build_backbone(dtype)
        if self.concat:
            self.concat_proj1 = Linear(512, 64, dtype=dtype)
            self.concat_proj2 = Linear(64, 1, dtype=dtype)
        self.correlation_aggreagtion = nn.ModuleList(
            ResBlock(self.num_bins, self.num_bins, dtype=dtype)
            for _ in range(3))
        if refinement in ("gru", "gru_feature"):
            self.local_cost_volume = GRUUpdate(
                self.num_bins, gru_hidden, num_samples,
                feature_dim=64 if refinement == "gru_feature" else 0,
                dtype=dtype)
            return
        if upsample == "convex":
            self.upsample_mask = ConvAffinityUpsample(dtype=dtype)
        if refinement.startswith("learned"):
            self.local_cost_volume = LearnedBounds(
                self.num_bins, num_samples,
                relative=refinement == "learned_supervised")

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                iters: int = 12) -> dict:
        """left, right: normalised images [B, H, W, 3], H and W multiples
        of 8.

        Returns {"disparities": [B, H, W, 1] each (``iters`` of them for
        the GRU refinements, [disp_low] for "none", [initial, refined]
        for the others), "disp_low": [B, H/8, W/8, 1]}, and for
        "learned_supervised" "bounds": (lower, upper) [B, H/8, W/8, 1]
        each."""
        B = left.shape[0]
        fused = self._features(left, right)
        feats = fused.permute(0, 2, 3, 1)
        if self.concat:
            cvol = concat_volume(feats[:B], feats[B:], self.num_bins)
            volume = self.concat_proj2(
                torch.relu(self.concat_proj1(cvol)))[..., 0]
        else:
            volume = correlation_volume(feats[:B].contiguous(),
                                        feats[B:].contiguous(), self.num_bins)

        v = volume.permute(0, 3, 1, 2)
        for block in self.correlation_aggreagtion:
            v = block(v)
        volume = v.permute(0, 2, 3, 1).float().contiguous()
        disp_low = soft_argmin(volume)[..., None]
        out = {"disp_low": disp_low}

        if self.refinement in ("gru", "gru_feature"):
            lf = fused[:B] if self.refinement == "gru_feature" else None
            out["disparities"] = self._gru(volume, disp_low, left, right, lf,
                                           iters)
            return out

        mask = (self.upsample_mask(fused[:B]) if self.upsample == "convex"
                else None)
        if self.refinement == "none":
            out["disparities"] = [self._up(disp_low, mask)]
            return out
        if self.refinement == "fixed":
            refined = fixed_local_cost_volume(volume, disp_low, self.radius,
                                              self.num_samples,
                                              consider_valid=True)
        elif self.refinement == "variance":
            refined = variance_local_cost_volume(volume, disp_low, self.gamma,
                                                 self.num_samples,
                                                 consider_valid=True)
        else:
            refined, bounds = self.local_cost_volume(
                volume, disp_low, left, right,
                consider_valid=self.refinement == "learned")
            if self.refinement == "learned_supervised":
                out["bounds"] = bounds
        out["disparities"] = [self._up(disp_low, mask),
                              self._up(refined, mask)]
        return out
