"""RAFT-Stereo, train and eval, float32; eval also in bf16.

Counterpart of ``stereoformer_tpu/models/raft_stereo.py::RAFTStereo``: a
context net (per-scale hidden state and GRU gate biases) and a feature net
run over the stacked pair at 1/2^``downsample``, the all-pairs 1D
correlation pyramid of ``corr_levels`` levels read at ``corr_radius``,
``iters`` steps of the ``n_gru_layers``-level GRU cascade with the flow
update held to the epipolar line, and the learned convex 2^``downsample``x
upsample. The options and their defaults are the JAX model's (hidden
widths 128, 4 levels of radius 4, 3 GRU levels, downsample 2). The hidden
widths must be equal: the JAX model gives context level ``i`` width
``hidden_dims[i]`` but builds the finest GRU with ``hidden_dims[2]``, so
unequal widths fail there on a shape mismatch, and here they raise.
Outputs are the negated flow, so positive disparities. Submodule names
follow the reference ``state_dict`` keys (``raft_stereo.py``); a module the
JAX model does not build at an option set (``gru32`` and ``layer5`` below
three levels) is absent.

Inputs are NHWC [B, H, W, 3]; the encoders run ``channels_last``, so the
fused conv reads their activations without a layout copy. In train mode the
context net's batch norms take the batch's statistics; every iteration
starts from a detached ``coords1``, as the reference's, so no gradient flows
from one iteration to the next through the coordinates (the hidden state
still carries it). ``remat_update=True`` checkpoints each iteration's
update block (``torch.utils.checkpoint``, non-reentrant), as the JAX
model's ``nn.remat``: less memory, the same values, the block run again in
the backward.

``dtype=torch.bfloat16`` is the JAX model's: the encoders, the context
gates and the GRU cascade compute in bf16 (``nn/raft``); the all-pairs
correlation is summed in float32 and stored as a bf16 pyramid; the lookup,
the coordinates, the flow head's last conv, the mask and the upsample stay
float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..nn import bf16
from ..nn.conv import Conv2d, check_dtype
from ..nn.raft import BasicEncoder, MultiBasicEncoder, MultiUpdateBlock
from ..ops import allpairs_corr1d, corr_lookup, corr_pyramid, upsample_convex


class RAFTStereo(nn.Module):
    def __init__(self, hidden_dims=(128, 128, 128), downsample: int = 2,
                 corr_levels: int = 4, corr_radius: int = 4,
                 n_gru_layers: int = 3, input_norm: str = "raw",
                 remat_update: bool = False, dtype=None):
        super().__init__()
        if input_norm not in ("raw", "imagenet"):
            raise ValueError(f"unknown input_norm {input_norm!r}")
        hidden_dims = tuple(hidden_dims)
        if len(hidden_dims) != 3 or len(set(hidden_dims)) != 1:
            raise ValueError(
                f"hidden_dims must be three equal widths, got {hidden_dims}: "
                f"the JAX model gives context level i hidden_dims[i] "
                f"channels but builds the finest GRU (gru08) with "
                f"hidden_dims[2], so unequal widths do not run there either")
        dtype = check_dtype(dtype)
        self.input_norm = input_norm
        self.remat_update = remat_update
        self.compute_dtype = dtype
        self.downsample = downsample
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.cnet = MultiBasicEncoder((hidden_dims, hidden_dims), downsample,
                                      n_gru_layers, dtype)
        self.fnet = BasicEncoder(256, downsample, dtype)
        self.context_zqr_convs = nn.ModuleList(
            Conv2d(hidden_dims[i], 3 * hidden_dims[i], 3, padding=1,
                   dtype=dtype)
            for i in range(n_gru_layers))
        self.update_block = MultiUpdateBlock(hidden_dims, corr_levels,
                                             corr_radius, n_gru_layers,
                                             downsample, dtype)

    def _normalize(self, x):
        """To [-1, 1] from 0..255 ("raw") or from ImageNet normalisation."""
        if self.input_norm == "imagenet":
            mean = x.new_tensor(IMAGENET_MEAN)
            std = x.new_tensor(IMAGENET_STD)
            return 2.0 * (x * std + mean) - 1.0
        return 2.0 * (x / 255.0) - 1.0

    def encode(self, left, right):
        """-> (context list, fmap1, fmap2), the feature maps NHWC."""
        left, right = self._normalize(left), self._normalize(right)
        cnet_list = self.cnet(left.permute(0, 3, 1, 2))
        # one feature-net pass over the stacked pair, then split
        fmaps = self.fnet(torch.cat([left, right]).permute(0, 3, 1, 2))
        fmaps = fmaps.permute(0, 2, 3, 1)
        B = left.shape[0]
        return cnet_list, fmaps[:B], fmaps[B:]

    def context_gates(self, inp):
        """Per-scale (cz, cr, cq) GRU gate biases from the context."""
        return [tuple(conv(c).chunk(3, dim=1))
                for conv, c in zip(self.context_zqr_convs, inp)]

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                iters: int = 12, flow_init=None, test_mode: bool = False):
        """left, right [B, H, W, 3] (0..255, or ImageNet-normalised with
        ``input_norm="imagenet"``); flow_init [B, H/f, W/f, >=1], f =
        2^``downsample`` (its first channel shifts the match).

        Returns {"disparities": iters x [B, H, W, 1] (only the last with
        ``test_mode``), "flow_low": [B, H/f, W/f, 1], "disp_low": its
        negation}."""
        cnet_list, fmap1, fmap2 = self.encode(left, right)
        net = [bf16.tanh(h) for h, _ in cnet_list]
        ctx = self.context_gates([torch.relu(c) for _, c in cnet_list])

        corr = allpairs_corr1d(fmap1, fmap2)
        if self.compute_dtype is not None:
            corr = corr.to(self.compute_dtype)
        pyramid = corr_pyramid(corr, self.corr_levels)
        B, H4, W4 = fmap1.shape[:3]
        coords0 = torch.arange(W4, dtype=torch.float32,
                               device=left.device).expand(B, H4, W4)
        coords1 = coords0 if flow_init is None else coords0 + flow_init[..., 0]
        flow_y = coords0.new_zeros((B, 1, H4, W4))

        preds = []
        for itr in range(iters):
            coords1 = coords1.detach()
            corr = corr_lookup(pyramid, coords1, self.corr_radius)
            flow = torch.cat([(coords1 - coords0)[:, None], flow_y], dim=1)
            last = itr == iters - 1
            args = (net, ctx, corr.permute(0, 3, 1, 2), flow)
            if self.remat_update and torch.is_grad_enabled():
                net, mask, delta = checkpoint(
                    self.update_block, *args, need_mask=not test_mode or last,
                    use_reentrant=False)
            else:
                net, mask, delta = self.update_block(
                    *args, need_mask=not test_mode or last)
            # the epipolar constraint: the flow moves along x only
            coords1 = coords1 + delta[:, 0]
            if test_mode and not last:
                continue
            flow_up = upsample_convex((coords1 - coords0)[..., None],
                                      mask.permute(0, 2, 3, 1),
                                      2 ** self.downsample)
            preds.append(-flow_up)
        flow_low = (coords1 - coords0)[..., None]
        return {"disparities": preds, "flow_low": flow_low,
                "disp_low": -flow_low}
