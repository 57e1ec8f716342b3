#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stereoformer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]     # from the root of a checkout

Needs one CUDA device and nvcc; imports nothing of JAX. Phases, in order;
any failure exits nonzero and prints no result:

1. the card's name and power limit, as nvidia-smi gives them;
2. build every CUDA kernel from csrc/, one nvcc per source, all at once,
   and print each entry function's registers and spills as ptxas gives them;
3. each kernel against its plain PyTorch version at the main paths' shapes
   and at edge inputs, with the tolerance stated: the two forward kernels,
   local_soft_argmin's backward kernel (also at D in {50, 96, 256} with S
   in {21, 33, 128}, past the old kernels' limits, with 1, 2 and 4 lanes a
   pixel, and bit-equal to itself on a second call), corr_band (also at D
   in {50, 96, 256}, with W below D and W that no 32-pixel tile divides),
   corr_band's backward (torch ops) against autograd of its plain version,
   conv2d_fused in every variant, conv2d_dw against float64 sums at RAFT's
   four training shapes (and bit-equal to itself on a second call), the
   fused conv's backward (conv2d_fused for dx, conv2d_dw for dw, torch ops
   for the rest) in all six variants against autograd of its plain version,
   deform_sample (the fused kernel: x, offsets, mask and weight in) against
   the plain windowed form in float64 at the learned bounds' eval and train
   shapes, an odd W, dilation 2, offsets beyond the window, integer
   offsets, Co = 5, 6, 24, 32, 256, C = 6, 40, 64, 128, 256, windows 1, 3,
   8 and 24 (the last too wide for a halo in shared memory), tile edges and
   k = 5, and bit-equal to itself on a second call,
   conv2d_s2 with and without ReLU against the plain version in float64 at
   RAFT's six stride-2 sites and edge shapes, with its gradient, and
   row_gather bit-equal to its plain version at the probe's shape, an index
   out of range raising;
4. LowCNN_gru eval through get_model at 576x960, B=8, 12 GRU iterations,
   float32, random weights from seed 0: launch counts (corr_band once,
   local_soft_argmin once per iteration, no backward), shapes, finiteness
   and range; the steady-state time with CUDA events (cuDNN's TF32 on and
   off); a profiler breakdown of one forward;
5. the LowCNN_gru train step through train.make_train_step at 320x640,
   B=4 and B=8, 12 GRU iterations, sequence loss, AMSGrad lr 1e-3, float32:
   launch counts per step (corr_band 1, local_soft_argmin 12, its backward
   12), a finite loss that falls over 5 steps on one batch, ms/step and
   pairs/s, peak memory, a profiler breakdown of one B=4 step;
6. LowCNN_dynamic eval as in phase 4 (576x960, B=8): launch counts
   (corr_band, local_soft_argmin and deform_sample once each), shapes,
   finiteness and range, ms/batch with TF32 on and off, a profiler
   breakdown;
7. the LowCNN_dynamic_supervised train step at 320x640, B=4,
   range_supervised loss, AMSGrad lr 1e-3, float32: launch counts per step
   (corr_band, local_soft_argmin, its backward and deform_sample once
   each), a finite loss that falls over 5 steps on one batch, ms/step
   (TF32 on and off), the parts of a step, peak memory, a profiler
   breakdown; then one LowCNN_dynamic train step with the "equal" loss: a
   finite loss and the same launch counts;
8. the rest of the family as in phases 4 and 5: LowCNN (fixed radius),
   LowCNN_simple (no refinement), LowCNN_ada (variance) and LowCNN_gru2 (the
   GRU with the left feature, 12 iterations) eval at 576x960, B=8 (launches
   corr_band / local_soft_argmin 1/1, 1/0, 1/1, 1/12); the LowCNN_ada
   ("equal" loss) and LowCNN_gru2 ("sequence") train steps at 320x640, B=4
   (corr_band / local_soft_argmin / its backward 1/1/1 and 1/12/12 per
   step, a falling loss over 5 steps, peak memory);
8b. LowCNN_gru(max_disp=400, num_samples=32), D = 50 and S = 33, on the
   card against the port on the CPU at 64x256 (TF32 off): the eval forward
   and one train step (loss, gradient norm, updated parameters); then
   LowCNN_gru(max_disp=768) eval at 576x960, B=8, as in phase 4 (D = 96:
   launch counts, finiteness and range, ms/batch);
8c. CrossAttentionStereo (the registry's widths: 8 heads, qk 128, D 24)
   eval at 576x960, B=8, 12 GRU iterations (launches: corr_band 0,
   local_soft_argmin 12), ms/batch with TF32 on and off, peak memory and
   the device's busy share; its "sequence" train step at 320x640, B=4
   (local_soft_argmin and its backward 12 each a step, a falling loss);
9. RAFT_Stereo eval through get_model at 576x960, B=2 and B=8, 12 GRU
   iterations, test_mode, float32, random weights from seed 0: 14 launches
   of conv2d_fused per forward (7 in each encoder), shapes and finiteness,
   ms/batch and pairs/s with CUDA events (cuDNN's TF32 on and off), peak
   memory, a profiler breakdown of one B=2 forward;
10. the RAFT_Stereo train step through train.make_train_step at 320x720,
   B=4, 12 GRU iterations, sequence loss (gamma 0.8), AMSGrad lr 2e-4,
   float32 (bench.py's RAFT protocol): launch counts per step (conv2d_fused
   28: 14 forward, 14 dx; conv2d_dw 14), the cotangent copies the backward
   made, a finite loss that falls over 5 steps on one batch, ms/step and
   pairs/s (TF32 on and off), the parts of a step, peak memory, a profiler
   breakdown of one step;
11. the two kernels no model path reaches, through their public entry
   points: conv2d_fused_s2 at RAFT's six stride-2 sites (which stay cuDNN
   convs in the model, as they stay XLA convs in the JAX package), and the
   row-gather probe (stereoformer_tpu_torch.scripts.gather_probe): one
   launch per call;
12. each kernel's device time beside its bound and its plain version's
   (corr_band, local_soft_argmin and its backward also at D = 96, S = 33);
   for the three 3xTF32 conv kernels also their 3xTF32 and one-pass TF32
   bounds, their share of the 3xTF32 bound, their ratio to cuDNN's float32
   time and their registers and spills: conv2d_fused beside one F.conv2d
   with bias at the same shape (TF32 on and off), at the four RAFT eval
   shapes, and as the dx conv at the four RAFT training shapes beside
   cuDNN's conv2d_input; conv2d_dw, at the four training shapes, beside
   cuDNN's conv2d_weight (TF32 on and off);
   for deform_sample at the learned bounds' eval and train shapes, beside
   torchvision's deform_conv2d where torchvision imports, and the time of
   the deformable conv's backward (autograd of the plain windowed form) at
   the train shape; for conv2d_s2 at RAFT's six stride-2 sites beside
   one F.conv2d with stride 2 (TF32 off and on); for row_gather at the
   probe's shape beside torch.gather;
13. parity of the card against the port on the CPU (TF32 off): LowCNN_gru
   at 64x256, the eval forward and one train step (loss, gradient norm,
   updated parameters); LowCNN_dynamic_supervised at 64x256 likewise
   (range_supervised loss), with offsets of about a pixel; RAFT_Stereo
   eval at 64x128, 12 iterations, and one RAFT train step at 64x128, 2
   iterations (loss, gradient norm, updated parameters); LowCNN_gru2 at
   64x256, eval and one train step; LowCNN with the concat volume and the
   simple upsample, eval; CrossAttentionStereo at 64x256, eval and one
   train step (as LowCNN_gru2's);
14. the training system through python -m stereoformer_tpu_torch.cli.train's
   main on dummy:32 at 320x640, B=4 (test_batch 4), 12 GRU iterations,
   config/loss_config_disp.json, 4 decode workers, cuDNN deterministic and
   torch's deterministic algorithms (warning only: the ops that have no
   deterministic kernel are printed): 2 epochs, --resume to 3, and an
   uninterrupted 3-epoch run in a second directory. The launch counts of
   the first run (corr_band 1, local_soft_argmin 12 and its backward 12 per
   train step, corr_band 1 and local_soft_argmin 12 per validation
   forward), a finite falling loss, the checkpoints and model_best, the
   resumed state (parameters, BatchNorm buffers, AMSGrad moments, count)
   against the uninterrupted one within RESUME_TOL; ms/step through the
   trainer beside phase 5's bare step, the share of it spent waiting for
   data, peak memory, the device's busy share over one epoch (the device
   time of a device-only profile over the epoch's wall time), and the
   seconds of one checkpoint;
15. the file path: a SceneFlow-shaped tree written here (32 pairs of
   540x960 PNG with PFM disparities under frames_finalpass/left, /right
   and disparity/left, train and val lists) read by
   StereoDataset, train_transform, DataLoader (4 threads, page-locked
   batches) and the prefetcher (non-blocking copies on a side stream):
   every batch of the 8-batch epoch on the card equals its host batch bit
   for bit, read as it is handed out and again behind a long kernel, with
   every buffer dropped as soon as it is used; the host pipeline's decode
   rate over the 32 pairs; one train epoch and a validation at 576x960
   with a final partial batch (a finite EPE); whether the native IO
   library (make -C native) was used;
16. the evaluation entry points, each through its main(argv) on the card,
   on phase 15's tree and phase 14's model_best: cli.evaluate (LowCNN_gru,
   SceneFlow val list, 576x960) against a loop over the same loader with
   the model restored from the same file (EPE, P1, D1 within 1e-4
   relative, at the CLI's 4 decimals); cli.infer --ckpt --gt --error-out
   on one pair (a PFM and an error PNG of the image's size, the printed
   EPE that of the same forward in the phase); cli.analysis --disp --out
   (the .npz keys and shapes); cli.gen_filelist over the tree (the tree's
   own train list, byte for byte); cli.evaluate --net CrossAttentionStereo
   --dataset dummy (its JSON line); launch counts of each;
17. bf16 serving, the JAX package's deployment dtype: the bf16 forms of
   corr_band and conv2d_fused against their plain bf16 versions (float32
   sums, one rounding; at most one bf16 ulp per output, or near 0 the
   float32 sums' own error, 2^-20 of the largest output; the moments within
   1e-5 relative beyond what the outputs that round to the neighbouring
   bf16 move them by), corr_band's at the eval, train and D = 96 shapes and
   at edge shapes (W below D, ragged W, C = 72 and 8, D in spans: 1024,
   256, 200; W one pixel past a 64- and a 128-pixel tile; its registers and
   its plan beside its times) and every conv2d_fused entry at RAFT's four
   eval sites and at edge shapes (H and W off its tile, C = 72, Co 64 and
   96 from C 64, 72 or 96), each timed at the main path's shapes by graph
   replay beside its bound (bytes at the HBM rate or operations at the bf16
   tensor-core rate), its plain version and the library (cuDNN's F.conv2d
   with bias in bf16, and the kernel/cuDNN ratio; none for corr_band);
   every registry name's eval at bench.py's protocol (576x960, B=8, RAFT at
   B=2 and B=8 on uniform 0..255 images, 12 iterations, seed-0 weights) in
   bf16 and float32: ms/batch (float32 with TF32 on and off, from the
   earlier phases where they ran the name), pairs/s, peak memory, launch
   counts (corr_band's bf16 form once per LowCNN forward, its float32 form
   never; conv2d_fused's bf16 form 14 times per RAFT forward), finite
   float32 disparities, and the bf16-against-float32 mean abs disparity
   beside bench.py's 0.25 px (a reading with random weights); a profiler
   breakdown of one bf16 forward of LowCNN_gru and RAFT (B=2); then the
   card's bf16 against the port's bf16 on the CPU, LowCNN_gru at 64x256 and
   RAFT at 64x128, TF32 off: the gap may be no larger than the CPU port's
   own bf16-against-float32 gap on the same input;
18. bf16 training, the JAX package's training dtype: conv2d_dw_bf16 (the
   bf16 form of conv2d_dw) against the plain version on float64 copies of
   the same bf16 inputs, rounded once, and the bf16 backward's dx conv
   (conv2d_fused_bf16 on the flipped weights) against its plain version
   (TF32 off), at RAFT's four train sites and at edge shapes, each within
   one bf16 ulp per output (or near 0 the float32 sums' own error) and
   bit-equal to itself on a second call; the bf16 train step at bench.py's
   widths: LowCNN_gru at 320x640, B=4 and B=8, RAFT_Stereo at 320x720,
   B=4 (AMSGrad at RAFT_LR), every other registry name at 320x640, B=4,
   12 iterations: launch counts per step (RAFT: conv2d_fused_bf16 28, of
   them 14 dx, conv2d_dw_bf16 14, no float32 conv form; LowCNN_gru:
   corr_band_bf16 1, local_soft_argmin and its backward 12 each), finite
   gradients for every parameter, float32 parameters, a loss that falls
   over 5 steps on one batch, peak memory beside the float32 step's, and
   ms/step by CUDA events, bf16 and float32 steps timed in turns (10
   pairs: the medians and the range of the per-pair ratio); the two new
   forms' device time at RAFT's four train sites beside their bound and the
   share of it they reach, their plain versions, cuDNN's bf16
   conv2d_weight and conv2d_input, and the float32 forms, and
   conv2d_dw_bf16's 14 launches of one RAFT bf16 step by graph replay and
   by the step's profile (dw_bf16_kernel and its reduction); one bf16
   train step of LowCNN_gru (64x256) and RAFT
   (64x128) on the card against the port's bf16 step on the CPU, TF32 off:
   2 iterations: the loss, the forward's disparities, each parameter's
   gradient tensor and the updated parameters within 1.5 times the CPU's
   own floor (the largest distance of a CPU step with one bf16 ulp changed
   at 0.1% of the left image, five seeds), as the tests hold the CPU port
   to JAX, the floors narrow enough that a gradient in a random direction
   would fail at two thirds of the leaves or more; cli.train
   --dtype bf16 on dummy data at 320x640, B=4: an epoch, --resume to a
   second, float32 parameters and moments in the checkpoints;
19. RAFT-Stereo's option sets: get_model("RAFT_Stereo", downsample=3,
   n_gru_layers=2) (the upstream real-time model's two options the JAX
   model has) at 576x960, B=2, 7 iterations, test_mode, in float32 and
   bf16, each timed in turn with the default at the same iterations (14
   conv2d_fused or conv2d_fused_bf16 launches a forward); its float32 train
   step at 320x720, B=4, 12 iterations, AMSGrad 2e-4, beside the default's
   (28 conv2d_fused and 14 conv2d_dw launches a step, a loss that falls
   over 4 steps, finite gradients), and its bf16 step (28
   conv2d_fused_bf16, 14 of them dx, and 14 conv2d_dw_bf16); downsample=1
   eval at 576x960, B=2 (16 launches: its 64 -> 96 layer2 entry routed
   too) and its float32 train step at B=1 (32 conv2d_fused and 16
   conv2d_dw launches); both sets' eval and the downsample=3 train step on
   the card against the CPU port at 64x128 with moderate weights, TF32 off
   (phase 13's bounds); conv2d_fused, its dx and conv2d_dw at the sites the
   sets move (1/2 and 1/4 at downsample=3, layer2 and its 64 -> 96 entry at
   full resolution at downsample=1), each timed beside its bounds and
   cuDNN;
20. the library modules no model calls, at full width, each on the card
   against the CPU port on the same inputs (TF32 off; the CPU on the first
   samples where the module runs each sample alone) and timed:
   ResSubmoduleAttention(scale=2, out_planes=64) without and with its
   deformable bottleneck on 576x960 images, B=8, a 1/4 disparity and a
   32-channel feature (one deform_sample launch a forward, at [8, 36, 60,
   256] -> 256; the kernel there against the plain version in phase 3, its
   tiling and its time beside its bound), Hourglass3D(32) train forward
   and backward on [1, 32, 48, 144, 240] (each gradient within 3 times the
   CPU float32's distance from the CPU's float64, and the statistics), the
   cost-volume pyramid of 32-channel features at 1/4, 1/8 and 1/16 with
   max_disp 192 in its three modes (3 corr_band launches in correlation),
   the four deformable convs at [8, 128, 72, 120] -> 128 and one at stride
   2, DeformRoIPoolingPack on [2, 256, 72, 120] with 128 RoIs, and
   SepConvGRU(128) at 1/8, B=8;
21. one JSON line with each kernel's numbers; the last line says the run
   was ok and names the device.

Phase 3 holds conv2d_fused against its plain version (TF32 off) in all four
variants (plain, prologue, moments, prologue and moments) and with residual
and ReLU, at the four shapes RAFT eval at B=2 gives it and at edge shapes (H
and W tails, odd widths, C=64 and C=96), and the moments of an output whose
variance is 0 (a prologue that zeroes every input).

With --json, everything measured (and the profiles' top kernels) is also
written to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W, B, ITERS = 576, 960, 8, 12
TRAIN_H, TRAIN_W, TRAIN_BATCHES, LR = 320, 640, (4, 8), 1e-3
RAFT_BATCHES = (2, 8)
# bench.py's RAFT train protocol (AMSGrad, as the trainer uses it)
RAFT_TRAIN_B, RAFT_TRAIN_H, RAFT_TRAIN_W, RAFT_LR = 4, 320, 720, 2e-4
# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 outside tensor
# cores, TF32 in them
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
# bench.py's BF16_AGREEMENT_PX: bf16 against float32, mean abs disparity
BF16_AGREEMENT_PX = 0.25
# conv2d_fused's calls in RAFT eval at B=2, 576x960 (name -> B, H, W, C=Co):
# the feature net runs on the stacked pair at full and half resolution,
# the context net on the left image
RAFT_CONVS = {"fnet layer1": (4, 576, 960, 64), "cnet layer1": (2, 576, 960, 64),
              "fnet layer2": (4, 288, 480, 96), "cnet layer2": (2, 288, 480, 96)}
# the same sites in the RAFT train step (B=4, 320x720): conv2d_dw's calls and
# the fused conv's dx convs
RAFT_TRAIN_CONVS = {
    "fnet layer1": (8, 320, 720, 64), "cnet layer1": (4, 320, 720, 64),
    "fnet layer2": (8, 160, 360, 96), "cnet layer2": (4, 160, 360, 96)}

# kernel name -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "corr_band": (
        "cuda", "stereoformer_tpu_torch/csrc/corr_band.cu",
        "stereoformer_tpu/ops/pallas/corr_band.py:48"),
    "local_soft_argmin": (
        "cuda", "stereoformer_tpu_torch/csrc/local_soft_argmin.cu",
        "stereoformer_tpu/ops/pallas/local_refine.py:56"),
    "local_soft_argmin_bwd": (
        "cuda", "stereoformer_tpu_torch/csrc/local_soft_argmin_bwd.cu",
        "stereoformer_tpu/ops/pallas/local_refine.py:129"),
    "conv2d_fused": (
        "cuda", "stereoformer_tpu_torch/csrc/conv2d_fused.cu",
        "stereoformer_tpu/ops/pallas/conv2d.py:218"),
    "conv2d_dw": (
        "cuda", "stereoformer_tpu_torch/csrc/conv2d_dw.cu",
        "stereoformer_tpu/ops/pallas/dw_conv.py:118"),
    "deform_sample": (
        "cuda", "stereoformer_tpu_torch/csrc/deform_sample.cu",
        "stereoformer_tpu/ops/pallas/deform_sample.py:90"),
    "conv2d_s2": (
        "cuda", "stereoformer_tpu_torch/csrc/conv2d_s2.cu",
        "stereoformer_tpu/ops/pallas/conv2d.py:585"),
    "row_gather": (
        "cuda", "stereoformer_tpu_torch/csrc/row_gather.cu",
        "scripts/_gather_probe.py:21"),
    # the bf16 forms: the same sources, their own C entries
    "corr_band_bf16": (
        "cuda", "stereoformer_tpu_torch/csrc/corr_band.cu",
        "stereoformer_tpu/ops/pallas/corr_band.py:48"),
    "conv2d_fused_bf16": (
        "cuda", "stereoformer_tpu_torch/csrc/conv2d_fused.cu",
        "stereoformer_tpu/ops/pallas/conv2d.py:218"),
    "conv2d_dw_bf16": (
        "cuda", "stereoformer_tpu_torch/csrc/conv2d_dw.cu",
        "stereoformer_tpu/ops/pallas/dw_conv.py:118"),
}
# RAFT's stride-2 3x3 sites at eval, B=2, 576x960 (the first conv of the
# first block of layer2 and layer3 in both encoders, and of the context
# net's layer4 and layer5; the feature net runs on the stacked pair). They
# stay cuDNN convs in the model, as they stay XLA convs in the JAX package;
# conv2d_fused_s2 is driven at their shapes. name -> (B, H, W, C, Co) of
# the input
RAFT_S2_CONVS = {
    "fnet layer2": (4, 576, 960, 64, 96), "fnet layer3": (4, 288, 480, 96, 128),
    "cnet layer2": (2, 576, 960, 64, 96), "cnet layer3": (2, 288, 480, 96, 128),
    "cnet layer4": (2, 144, 240, 128, 128),
    "cnet layer5": (2, 72, 120, 128, 128)}
# the JAX test's shape (an output of 10 x 24: a tail of 2 rows at 4-row
# tiles, Co short of one 32-channel block), an output that no 4 x 32 tile
# divides (17 x 33), and C, Co that are no multiple of 4 (C short of one
# 8-channel chunk)
EDGE_S2_CONVS = [(2, 20, 48, 16, 24), (1, 34, 66, 96, 128), (2, 18, 70, 6, 10)]
# the models with LowCNN's output contract (the LowCNN family and
# CrossAttentionStereo): name -> (outputs of a forward, launches in one eval
# forward); a train step adds one local_soft_argmin_bwd per forward launch
# of local_soft_argmin
LOWCNN = {
    "LowCNN_gru": (ITERS, {"corr_band": 1, "local_soft_argmin": ITERS}),
    "LowCNN_gru2": (ITERS, {"corr_band": 1, "local_soft_argmin": ITERS}),
    "LowCNN": (2, {"corr_band": 1, "local_soft_argmin": 1}),
    "LowCNN_simple": (1, {"corr_band": 1}),
    "LowCNN_ada": (2, {"corr_band": 1, "local_soft_argmin": 1}),
    "LowCNN_dynamic": (2, {"corr_band": 1, "local_soft_argmin": 1,
                           "deform_sample": 1}),
    "LowCNN_dynamic_supervised": (2, {"corr_band": 1, "local_soft_argmin": 1,
                                      "deform_sample": 1}),
    "CrossAttentionStereo": (ITERS, {"local_soft_argmin": ITERS}),
}


def train_launches(name: str) -> dict:
    counts = dict(LOWCNN[name][1])
    if "local_soft_argmin" in counts:
        counts["local_soft_argmin_bwd"] = counts["local_soft_argmin"]
    return counts
# deform_sample's calls: the learned bounds' DeformConv (16 -> 16 channels at
# 1/8 resolution) in LowCNN_dynamic eval (B=8, 576x960) and in the train
# step (B=4, 320x640): (B, H, W, C, Co)
DEFORM_SHAPES = {"eval": (B, H // 8, W // 8, 16, 16),
                 "train": (4, TRAIN_H // 8, TRAIN_W // 8, 16, 16)}
# and ResSubmoduleAttention's deformable bottleneck (phase 20): 256 -> 256
# channels at 1/16 of 576x960, B=8
DEFORM_RES_SHAPE = (B, H // 16, W // 16, 256, 256)


class SmokeFailure(RuntimeError):
    pass


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time per call of ``fn`` over ``reps`` back-to-back calls, by
    CUDA events: device time plus any gaps where the host launches slower
    than the device runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device time per call of ``fn``: ``reps`` calls captured in one
    CUDA graph, the graph replayed ``replays`` times between two CUDA
    events. A replay runs the captured kernels back to back with no host
    work between them, so this is the device's time for kernels of any
    size. No kernel time here comes from the profiler: on the H100 its
    kernel durations read low under sustained load (``profiler_ms``,
    recorded beside conv2d_s2's times in phase 12, shows by how much)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()   # outside the capture: cuDNN's plans, first allocations
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


def profiler_ms(fn, reps: int, match: str) -> float:
    """Mean device time per call of ``fn`` by the profiler's GPU events
    whose name contains ``match``: recorded only to show how far it
    strays from ``graph_ms``."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_device_us(e) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and match in e.key) / 1e3 / reps


def _device_us(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    return getattr(evt, "self_cuda_time_total", 0.0) if us is None else us


def compare(label: str, got: torch.Tensor, want: torch.Tensor,
            tol: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise SmokeFailure(f"{label}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    err = (got.double() - want.double()).abs().max().item()
    ok = bool(np.isfinite(err)) and err <= tol
    print(f"  {label}: max_abs_err {err:.3e} (tolerance {tol:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{label}: error {err} above {tol}")
    return err


def edge_candidates(rng, shape, D):
    """Uniform in [-2, D+2], a third of them set to exact integers, to the
    clip bounds 0 and D-1, and to values beyond them."""
    cands = rng.uniform(-2, D + 2, shape).astype(np.float32)
    special = np.array([0.0, D - 1.0, 5.0, 4.5, 6.0, -1.0, D, 11.0, -2.0],
                       np.float32)
    pick = rng.random(shape) < 0.3
    cands[pick] = rng.choice(special, size=int(pick.sum()))
    return cands


def reset_counts(ops) -> None:
    ops.correlation_volume.launches = 0
    ops.correlation_volume.bf16_launches = 0
    ops.conv2d_fused.bf16_launches = 0
    ops.conv2d_fused.bf16_dx_launches = 0
    ops.conv2d_dw.bf16_launches = 0
    ops.local_soft_argmin.launches = 0
    ops.local_soft_argmin.backward_launches = 0
    ops.conv2d_fused.launches = 0
    ops.conv2d_dw.launches = 0
    ops.deform_conv_fused.launches = 0
    ops.conv2d_fused_s2.launches = 0
    ops.take_rows.launches = 0


def read_counts(ops) -> dict:
    torch.cuda.synchronize()
    return {"corr_band": ops.correlation_volume.launches,
            "local_soft_argmin": ops.local_soft_argmin.launches,
            "local_soft_argmin_bwd": ops.local_soft_argmin.backward_launches,
            "conv2d_fused": ops.conv2d_fused.launches,
            "conv2d_dw": ops.conv2d_dw.launches,
            "deform_sample": ops.deform_conv_fused.launches,
            "conv2d_s2": ops.conv2d_fused_s2.launches,
            "row_gather": ops.take_rows.launches,
            "corr_band_bf16": ops.correlation_volume.bf16_launches,
            "conv2d_fused_bf16": ops.conv2d_fused.bf16_launches,
            # of conv2d_fused_bf16's, those of the backward's dx conv
            "conv2d_fused_bf16_dx": ops.conv2d_fused.bf16_dx_launches,
            "conv2d_dw_bf16": ops.conv2d_dw.bf16_launches}


def check_launches(label: str, got: dict, **want) -> None:
    """Fail unless ``got`` has the counts ``want`` and 0 elsewhere."""
    full = dict.fromkeys(got, 0)
    full.update(want)
    if got != full:
        raise SmokeFailure(f"{label} launches {got}, expected {full}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement here")
    opt = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # cuBLAS picks its workspace once per process: set it up for phase 14's
    # deterministic runs before any CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from stereoformer_tpu_torch import kernels, ops

    record: dict = {}
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    record["card"] = card
    record["torch"] = torch.__version__
    record["cuda"] = torch.version.cuda

    # 2. build
    build_s = kernels.build()
    print(f"build: {build_s:.1f} s for {len(kernels.KERNELS)} kernels",
          flush=True)
    record["build_s"] = build_s
    record["ptxas"] = {}
    for name in kernels.KERNELS:
        record["ptxas"][name] = usage = kernels.ptxas_usage(name)
        for entry, u in usage.items():
            print(f"  {name}: {entry} {u.get('registers')} registers, "
                  f"spills {u.get('spill_stores')} B stored, "
                  f"{u.get('spill_loads')} B loaded", flush=True)

    rng = np.random.default_rng(0)
    err = check_kernels(ops, rng)
    err["conv2d_fused"] = check_conv_kernel(ops, rng)
    err["conv2d_dw"] = check_dw_kernel(ops, rng)
    err["deform_sample"] = check_deform_kernel(ops, rng)
    err["conv2d_s2"] = check_s2_kernel(ops, rng)
    err["row_gather"] = check_gather_kernel(ops, rng)
    record["max_abs_err"] = err
    record["backward_rel_err"] = check_conv_backward(ops, rng)

    launches = {"eval_forward": eval_phase(ops, rng, record)}
    for batch in TRAIN_BATCHES:
        # every batch size must give the same counts per step
        launches["train_step"] = train_phase(
            ops, batch, record, profile_it=batch == TRAIN_BATCHES[0])
    launches["dynamic_eval"] = eval_phase(ops, rng, record, "LowCNN_dynamic",
                                          key="dynamic_eval")
    launches["dynamic_supervised_train_step"] = train_phase(
        ops, 4, record, "LowCNN_dynamic_supervised", "range_supervised",
        profile_it=True)
    launches["dynamic_train_step"] = dynamic_equal_step(ops, record)
    for name in ("LowCNN", "LowCNN_simple", "LowCNN_ada", "LowCNN_gru2"):
        launches[f"{name}_eval"] = eval_phase(ops, rng, record, name,
                                              key=f"{name}_eval")
    launches["LowCNN_ada_train_step"] = train_phase(
        ops, 4, record, "LowCNN_ada", "equal", profile_it=True)
    launches["LowCNN_gru2_train_step"] = train_phase(
        ops, 4, record, "LowCNN_gru2", "sequence", profile_it=True)
    # 8c. the cross-attention family
    launches["CrossAttentionStereo_eval"] = eval_phase(
        ops, rng, record, "CrossAttentionStereo",
        key="CrossAttentionStereo_eval")
    launches["CrossAttentionStereo_train_step"] = train_phase(
        ops, 4, record, "CrossAttentionStereo", "sequence", profile_it=True)
    # 8b. D = 50 and S = 33, past what the kernels took before
    record["wide_range_parity_vs_cpu"] = parity_vs_cpu(
        seed=4, max_disp=400, num_samples=32)
    launches["LowCNN_gru_max_disp_768_eval"] = eval_phase(
        ops, rng, record, key="max_disp_768_eval", max_disp=768)
    for batch in RAFT_BATCHES:
        launches["raft_eval"] = raft_eval_phase(
            ops, rng, batch, record, profile_it=batch == RAFT_BATCHES[0])
    launches["raft_train_step"] = raft_train_phase(ops, record)
    launches["conv2d_s2_sites"] = s2_path(ops, rng, record)
    launches["gather_probe"] = gather_probe_path(ops, record)
    record["launches"] = launches

    rows = kernel_rows(ops, rng, err, launches, record)
    rows.append(conv_row(ops, rng, err, launches, record))
    rows.append(dw_row(ops, rng, err, launches, record))
    rows.append(deform_row(ops, rng, err, launches, record))
    rows.append(s2_row(ops, rng, err, launches, record))
    rows.append(gather_row(ops, rng, err, launches, record))
    record["kernels"] = rows
    record["parity_vs_cpu"] = parity_vs_cpu()
    record["dynamic_parity_vs_cpu"] = dynamic_parity_vs_cpu()
    record["raft_parity_vs_cpu"] = raft_parity_vs_cpu()
    record["raft_train_parity_vs_cpu"] = raft_train_parity_vs_cpu()
    record["family_parity_vs_cpu"] = family_parity_vs_cpu()
    # 17. bf16 serving
    t17 = time.perf_counter()
    err.update(check_bf16_kernels(ops, rng))
    launches.update(bf16_eval_phase(ops, record))
    rows.extend(bf16_kernel_rows(ops, rng, err, launches, record))
    record["bf16_parity_vs_cpu"] = bf16_parity_vs_cpu()
    record["bf16_phase_s"] = time.perf_counter() - t17
    print(f"bf16 phase: {record['bf16_phase_s']:.1f} s", flush=True)
    # 18. bf16 training
    t18 = time.perf_counter()
    err.update(check_bf16_train_kernels(ops, rng))
    launches.update(bf16_train_phase(ops, record))
    rows.extend(bf16_train_kernel_rows(ops, rng, err, launches, record))
    # the bf16 dx conv is conv2d_fused_bf16 launched from the backward
    fused16 = next(r for r in rows if r["name"] == "conv2d_fused_bf16")
    fused16["dx"] = dict(
        record["kernel_times"]["conv2d_fused_bf16_dx"]["fnet layer1"],
        max_abs_err=err["conv2d_fused_bf16_dx"])
    record["bf16_train_parity_vs_cpu"] = bf16_train_parity_vs_cpu()
    launches["bf16_trainer_cli"] = bf16_cli_phase(ops, record)
    record["bf16_train_phase_s"] = time.perf_counter() - t18
    print(f"bf16 training phase: {record['bf16_train_phase_s']:.1f} s",
          flush=True)
    # phases 14-16 share a temporary tree (checkpoints of 290 MB, the
    # files), removed whatever the outcome
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches["trainer_cli"] = trainer_phase(ops, record, work)
        launches["file_path"] = file_path_phase(ops, record, work)
        launches.update(entry_points_phase(ops, record, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # 19. RAFT-Stereo's option sets; 20. the library modules
    launches.update(raft_options_phase(ops, rng, record))
    launches.update(library_modules_phase(ops, rng, record))
    add_option_site_times(rows, record)
    for path in launches:
        for row in rows:
            row["launches_by_path"].setdefault(path,
                                               launches[path][row["name"]])
    record["seconds"] = time.perf_counter() - t_start
    print(f"all phases passed in {record['seconds']:.1f} s", flush=True)

    if opt.json:
        os.makedirs(os.path.dirname(os.path.abspath(opt.json)), exist_ok=True)
        with open(opt.json, "w") as f:
            json.dump(record, f, indent=1)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def randn(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)).to("cuda")


def check_kernels(ops, rng) -> dict:
    """Phase 3: each kernel against its plain version on the card."""
    dev = torch.device("cuda")
    H8, W8, C, D, S = H // 8, W // 8, 256, 24, 21
    T8 = (TRAIN_H // 8, TRAIN_W // 8)
    print("kernels vs plain:", flush=True)
    err = {name: 0.0 for name in KERNELS}

    # float32 dots over C in another order than the plain version's
    corr_tol = 1e-5
    # the main path's D = 24 at its two shapes and at edge widths; then D
    # past the old kernel's 64: spans of 32 disparities in further blocks,
    # W below D, and W that no 32-pixel tile divides
    for shape, d in (((B, H8, W8, C), D), ((4, *T8, C), D), ((1, 4, 10, 64), D),
                     ((2, 5, 97, 40), D), ((1, 2, 300, 64), D),
                     ((2, 8, W8, C), 50), ((1, 4, 40, 64), 96),
                     ((1, 3, 97, 36), 96), ((1, 2, 300, 64), 256),
                     ((1, 2, 200, 64), 256)):
        left, right = randn(rng, *shape), randn(rng, *shape)
        e = compare(f"corr_band {shape} D={d}",
                    ops.correlation_volume(left, right, d),
                    ops.correlation_volume_plain(left, right, d), corr_tol)
        err["corr_band"] = max(err["corr_band"], e)
    # disparities in px up to ~26; exp and division in another order
    local_tol = 1e-4
    # gradients of O(1) cotangents times candidates up to ~26 px, summed in
    # another order than the plain version's dense [S, D] contraction
    bwd_tol = 1e-4
    for shape in ((B, H8, W8), (4, *T8), (1, 7, 19)):
        vol = randn(rng, *shape, D).requires_grad_(True)
        cands = torch.from_numpy(edge_candidates(rng, shape + (S,), D)).to(dev)
        cands.requires_grad_(True)
        out = ops.local_soft_argmin(vol, cands)
        e = compare(f"local_soft_argmin {shape}", out,
                    ops.local_soft_argmin_plain(vol, cands), local_tol)
        err["local_soft_argmin"] = max(err["local_soft_argmin"], e)
        g = randn(rng, *shape, 1)
        out.backward(g)
        want_v, want_c = ops.local_soft_argmin_backward_plain(
            vol.detach(), cands.detach(), g)
        e = max(compare(f"local_soft_argmin_bwd dvol {shape}", vol.grad,
                        want_v, bwd_tol),
                compare(f"local_soft_argmin_bwd dcand {shape}", cands.grad,
                        want_c, bwd_tol))
        err["local_soft_argmin_bwd"] = max(err["local_soft_argmin_bwd"], e)
    # past the old kernels' limits (D > 48 or S > 32) candidates reach D + 2
    # px and values and gradients grow with them: relative to each output's
    # largest magnitude (the absolute tolerances above are ~5e-6 and ~1.5e-5
    # of it at D = 24; tests/test_torch_refine_kernels.py emulates the
    # kernels' order within 3e-7 of it up to D = 256, S = 128)
    local_rel = 5e-6
    rel = {"local_soft_argmin": 0.0, "local_soft_argmin_bwd": 0.0}
    # 4 lanes a pixel at (2, 30, 61); the eval shape and half of it take 1
    # and 2 (the kernels pick them by the pixel count)
    for shape, d, s in [((2, 30, 61), d, s) for d in (50, 96, 256)
                        for s in (21, 33, 128)] + [
                            ((B, H8, W8), 96, 33), ((B // 2, H8, W8), 96, 33)]:
        vol = randn(rng, *shape, d).requires_grad_(True)
        cands = torch.from_numpy(edge_candidates(rng, shape + (s,), d))
        cands = cands.to(dev).requires_grad_(True)
        g = randn(rng, *shape, 1)
        out = ops.local_soft_argmin(vol, cands)
        out.backward(g)
        want = ops.local_soft_argmin_plain(vol.detach(), cands.detach())
        want_v, want_c = ops.local_soft_argmin_backward_plain(
            vol.detach(), cands.detach(), g)
        for name, part, got, w in (
                ("local_soft_argmin", "", out, want),
                ("local_soft_argmin_bwd", " dvol", vol.grad, want_v),
                ("local_soft_argmin_bwd", " dcand", cands.grad, want_c)):
            scale = w.abs().max().item()
            e = compare(f"{name}{part} {shape} D={d} S={s}", got, w,
                        local_rel * scale) / scale
            rel[name] = max(rel[name], e)
    # no atomics in the backward: a second call gives the same bits
    for shape, d, s in (((4, *T8), D, S), ((4, *T8), 96, 33)):
        vol = randn(rng, *shape, d).requires_grad_(True)
        cands = torch.from_numpy(edge_candidates(rng, shape + (s,), d))
        cands = cands.to(dev).requires_grad_(True)
        g = randn(rng, *shape, 1)
        out = ops.local_soft_argmin(vol, cands)
        first = torch.autograd.grad(out, (vol, cands), g, retain_graph=True)
        second = torch.autograd.grad(out, (vol, cands), g)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        print(f"  local_soft_argmin_bwd {shape} D={d} S={s}: bit-equal on a "
              f"second call {'ok' if same else 'FAIL'}", flush=True)
        if not same:
            raise SmokeFailure("local_soft_argmin_bwd is not deterministic")
    err["rel_past_old_limits"] = rel

    # corr_band's backward (torch ops) against autograd of the plain version
    left = randn(rng, 4, *T8, C).requires_grad_(True)
    right = randn(rng, 4, *T8, C).requires_grad_(True)
    g = randn(rng, 4, *T8, D)
    ops.correlation_volume(left, right, D).backward(g)
    got = (left.grad, right.grad)
    left.grad = right.grad = None
    ops.correlation_volume_plain(left, right, D).backward(g)
    compare(f"corr_band backward dleft {tuple(left.shape)}", got[0],
            left.grad, corr_tol)
    compare(f"corr_band backward dright {tuple(left.shape)}", got[1],
            right.grad, corr_tol)
    return err


def conv_inputs(rng, B, Hc, Wc, C, Co):
    """x, w, b, s, t, residual for conv2d_fused: weights scaled by
    1/sqrt(9 C), prologue scales in [0.5, 1.5]."""
    x = randn(rng, B, Hc, Wc, C)
    w = randn(rng, 3, 3, C, Co) / np.sqrt(9 * C)
    b = 0.1 * randn(rng, Co)
    s = torch.from_numpy(rng.uniform(0.5, 1.5, (B, C)).astype(np.float32))
    return x, w, b, s.cuda(), 0.5 * randn(rng, B, C), randn(rng, B, Hc, Wc, Co)


def conv_calls(ops, x, w, b, s, t, r) -> dict:
    """variant -> (a call of its entry point, the plain version's keyword
    arguments)."""
    return {
        "plain": (lambda: ops.conv2d_fused(x, w, b, None, False), {}),
        "residual+relu": (lambda: ops.conv2d_fused(x, w, b, r, True),
                          {"residual": r, "relu": True}),
        "prologue": (lambda: ops.conv2d_fused_prologue(x, w, b, s, t),
                     {"s": s, "t": t}),
        "stats": (lambda: ops.conv2d_fused_stats(x, w, b),
                  {"with_stats": True}),
        "prologue+stats": (
            lambda: ops.conv2d_fused_prologue_stats(x, w, b, s, t),
            {"s": s, "t": t, "with_stats": True}),
    }


def check_conv_kernel(ops, rng) -> float:
    """Phase 3, conv2d_fused: every variant against the plain version
    (cuDNN with TF32 off) at RAFT's four shapes, its 64 -> 96 entry at
    downsample=1 and edge shapes; returns the largest absolute error of
    y."""
    torch.backends.cudnn.allow_tf32 = False
    # 3xTF32 products summed per 8-channel chunk on the tensor cores and
    # folded into float32 totals, in another order than cuDNN's (input
    # channel chunk, then tap), and fmaf in the prologue: relative to the
    # largest |y|
    y_rtol = 1e-5
    # moments: per-block float32 sums added in float64, against float64
    # sums of the plain output; S1 and S2 relative to their largest value,
    # and the variance S2/n - (S1/n)^2 the norm takes, relative to itself
    m_rtol, var_rtol = 1e-5, 1e-4
    shapes = [(B_, H_, W_, C_, C_) for B_, H_, W_, C_ in RAFT_CONVS.values()]
    # and RAFT's 64 -> 96 layer2 entry at downsample=1 (the context net's)
    shapes.append(RAFT_DS1_CONVS["cnet layer2 entry"])
    worst = 0.0
    print("conv2d_fused vs plain (TF32 off):", flush=True)
    for shape in shapes + EDGE_CONVS:
        x, w, b, s, t, r = conv_inputs(rng, *shape)
        for name, (call, kw) in conv_calls(ops, x, w, b, s, t, r).items():
            got = call()
            want = ops.conv3x3_plain(x, w, b, **kw)
            if not kw.get("with_stats"):
                got, want = (got,), (want,)
            label = f"conv2d_fused {name} {shape}"
            worst = max(worst, compare(label, got[0], want[0],
                                       y_rtol * want[0].abs().max().item()))
            if len(got) == 1:
                continue
            for k, g, m in (("S1", got[1], want[1]), ("S2", got[2], want[2])):
                compare(f"{label} {k}", g, m, m_rtol * m.abs().max().item())
            n = shape[1] * shape[2]
            var_g = got[2].double() / n - (got[1].double() / n) ** 2
            var_w = want[2].double() / n - (want[1].double() / n) ** 2
            rel = ((var_g - var_w).abs() / var_w.abs()).max().item()
            print(f"  {label} variance: relative error {rel:.2e} "
                  f"(tolerance {var_rtol:g})", flush=True)
            if not rel <= var_rtol:
                raise SmokeFailure(f"{label}: variance error {rel}")
        del x, w, b, s, t, r, got, want
    # a prologue that zeroes every input: y = b, so each channel's variance
    # is 0; the moments stay finite and the variance the norm takes is the
    # float32 rounding of the sums, within 1e-5 of S2/n
    x, w, b, s, t, _ = conv_inputs(rng, 1, 19, 40, 64, 64)
    y, s1, s2 = ops.conv2d_fused_prologue_stats(x, w, b, s, t - 100.0)
    label = "conv2d_fused prologue+stats, zero variance (1, 19, 40, 64, 64)"
    compare(label, y, b.expand_as(y), 0.0)
    m1, m2 = s1.double() / (19 * 40), s2.double() / (19 * 40)
    var_err = ((m2 - m1 ** 2).abs() / m2).nan_to_num(0.0).max().item()
    ok = bool(torch.isfinite(s1).all() and torch.isfinite(s2).all()
              and var_err <= var_rtol * 0.1)
    print(f"  {label} variance: {var_err:.2e} of S2/n (tolerance "
          f"{var_rtol * 0.1:g}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{label}: moments not finite or variance {var_err}")
    torch.backends.cudnn.allow_tf32 = True
    return worst


EDGE_CONVS = [(1, 37, 53, 96, 96), (2, 19, 40, 64, 64), (1, 17, 45, 64, 64),
              (1, 9, 33, 96, 96)]


def check_dw_kernel(ops, rng) -> float:
    """Phase 3, conv2d_dw: against float64 sums (the plain version on
    float64 copies) at RAFT's four training shapes, its 64 -> 96 entry at
    downsample=1 and edge shapes, and bit-equal to itself on a second
    call; returns the largest absolute error."""
    # 3xTF32 products summed in float32 over a block's pixels, the blocks'
    # partials added in float64: relative to the largest |dw|
    rtol = 2e-5
    shapes = [(*v, v[3]) for v in RAFT_TRAIN_CONVS.values()]
    # and RAFT's 64 -> 96 layer2 entry at downsample=1 (the context net's)
    shapes.append(RAFT_DS1_TRAIN_CONVS["cnet layer2 entry"])
    worst = 0.0
    print("conv2d_dw vs float64 sums:", flush=True)
    for shape in shapes + EDGE_CONVS:
        B_, H_, W_, C, Co = shape
        x, g = randn(rng, B_, H_, W_, C), randn(rng, B_, H_, W_, Co)
        got = ops.conv2d_dw(x, g)
        want = ops.conv2d_dw_plain(x.double(), g.double())
        scale = want.abs().max().item()
        e = compare(f"conv2d_dw {shape} (largest |dw| {scale:.1f})", got,
                    want, rtol * scale)
        worst = max(worst, e)
        # the partials are summed in a fixed order: a second call gives the
        # same bits
        if not torch.equal(ops.conv2d_dw(x, g), got):
            raise SmokeFailure(f"conv2d_dw {shape}: two calls differ")
        del x, g, got, want
    print("  conv2d_dw: two calls on the same inputs gave the same bits at "
          "every shape", flush=True)
    return worst


# variant -> (residual, prologue, moments, relu), as the fused conv's VJPs
# see them in RAFT (and residual+relu, its other epilogue)
BACKWARD_VARIANTS = {
    "bare": (False, False, False, False),
    "residual+relu": (True, False, False, True),
    "prologue": (False, True, False, False),
    "prologue+relu": (False, True, False, True),
    "stats": (False, False, True, False),
    "prologue+stats": (False, True, True, False),
}


def check_conv_backward(ops, rng) -> dict:
    """Phase 3, the fused conv's backward on the card: every variant at
    RAFT's four training shapes and at two edge shapes against autograd of
    conv3x3_plain on float64 copies of the inputs, from a loss that uses y
    and both moments; each call must launch conv2d_fused twice (forward,
    dx) and conv2d_dw once. Float64, because cuDNN's own float32 weight
    gradient (TF32 off) is the less exact of the two: 6.5e-5 norm-wise
    from the kernel's at [8,320,720,64], whose dw is within 2.2e-6 of
    float64 sums there. With an output ReLU the reference applies the
    kernel's mask (y > 0) to its pre-activation: a handful of the 1e8
    outputs lie within float32 rounding of 0, and each passes its gradient
    on one side and blocks it on the other (3e-4 norm-wise measured with
    the float64 ReLU); their count is printed. Likewise the prologue's
    ReLU: the reference takes the backward's float32 mask of x s + t (a
    multiply and an add in float32 can round a pre-activation within a few
    ulps of 0 to the other side: with the float64 mask one draw failed at
    7.4e-5 norm-wise in dx at [8,320,720,64], the size of one flipped input
    of 1.2e8), and the count where it differs from float64 is printed.
    Returns each gradient's largest norm-wise relative error, and the most
    outputs and inputs whose ReLU mask differs from float64's in one
    call."""
    from stereoformer_tpu_torch.ops.fused_conv import conv3x3_fused

    torch.backends.cudnn.allow_tf32 = False
    # norm-wise, relative to the float64 gradient: float32 sums (dw over up
    # to 1.8 M pixels in float32 per block, then float64)
    rtol = 1e-5
    shapes = [(*v, v[3]) for v in RAFT_TRAIN_CONVS.values()]
    worst: dict = {}
    print("fused conv backward vs autograd of conv3x3_plain in float64:",
          flush=True)
    for shape in shapes + EDGE_CONVS[:2]:
        B_, H_, W_, C, Co = shape
        x, w, b, s, t, r = conv_inputs(rng, *shape)
        cy = randn(rng, B_, H_, W_, Co)
        c1, c2 = 0.1 * randn(rng, B_, Co), 0.01 * randn(rng, B_, Co)
        for name, (res, pro, stats, relu) in BACKWARD_VARIANTS.items():
            inputs = {"x": x, "w": w, "b": b}
            if res:
                inputs["residual"] = r
            if pro:
                inputs.update(s=s, t=t)

            def grads(fn, dtype=torch.float32, mask=None):
                """-> (y, or the pre-activation with ``mask``; gradients)"""
                v = {k: a.detach().to(dtype, copy=True).requires_grad_(True)
                     for k, a in inputs.items()}
                out = fn(v["x"], v["w"], v["b"], v.get("residual"),
                         relu and mask is None, v.get("s"), v.get("t"), stats)
                y = out[0] if stats else out
                if mask is not None:
                    out = y * mask
                loss = ((out[0] * cy).sum() + (out[1] * c1).sum()
                        + (out[2] * c2).sum()) if stats else (out * cy).sum()
                return y.detach(), dict(zip(
                    v, torch.autograd.grad(loss, list(v.values()))))

            n = ops.conv2d_fused.launches, ops.conv2d_dw.launches
            y, got = grads(conv3x3_fused)
            torch.cuda.synchronize()
            made = (ops.conv2d_fused.launches - n[0],
                    ops.conv2d_dw.launches - n[1])
            if made != (2, 1):
                raise SmokeFailure(f"backward {name} {shape}: launches {made},"
                                   f" expected 2 of conv2d_fused, 1 of "
                                   f"conv2d_dw")
            mask = (y > 0).double() if relu else None
            reference, pflips = ops.conv3x3_plain, 0
            if pro:
                # the prologue's ReLU with the backward's own float32 mask
                # (fused_conv_backward: x s + t > 0, a multiply and an add)
                u = x * s[:, None, None, :] + t[:, None, None, :]
                pmask = (u > 0).double()
                u64 = x.double() * s.double()[:, None, None, :] + t.double()[
                    :, None, None, :]
                pflips = int(((u64 > 0).double() != pmask).sum())
                del u, u64

                def reference(x_, w_, b_, r_, relu_, s_, t_, stats_):
                    z = (x_ * s_[:, None, None, :] + t_[:, None, None, :]
                         ) * pmask
                    return ops.conv3x3_plain(z, w_, b_, r_, relu_, None,
                                             None, stats_)

            pre, want = grads(reference, torch.float64, mask)
            flips = int(((pre > 0).double() != mask).sum()) if relu else 0
            errs = {k: ((got[k].double() - want[k]).norm()
                        / want[k].norm()).item() for k in want}
            ok = all(np.isfinite(e) and e <= rtol for e in errs.values())
            print(f"  {name} {shape}: " + ", ".join(
                f"d{k} {e:.1e}" for k, e in errs.items())
                + (f"; ReLU mask differs from float64 at {flips} outputs"
                   if relu else "")
                + (f"; prologue mask differs from float64 at {pflips} inputs"
                   if pro else "")
                + f" (tolerance {rtol:g}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SmokeFailure(f"backward {name} {shape}: errors {errs}")
            for k, e in errs.items():
                worst[k] = max(worst.get(k, 0.0), e)
            for k, n in (("relu_mask_flips", flips),
                         ("prologue_mask_flips", pflips)):
                worst[k] = max(worst.get(k, 0), n)
            del got, want, y, pre
        del x, w, b, s, t, r, cy
    torch.backends.cudnn.allow_tf32 = True
    return worst


# deform_sample's checks: (B, H, W, C, Co), padding, dilation, the offsets'
# scale (uniform in +-scale px) or "integer" (0, +-1, +-2, 3), the window
# and the kernel size
DEFORM_CASES = {
    "eval shape": (DEFORM_SHAPES["eval"], 1, 1, 1.8, 2, 3),
    "train shape": (DEFORM_SHAPES["train"], 1, 1, 1.8, 2, 3),
    "odd W, Co 6": ((2, 13, 17, 8, 6), 1, 1, 1.8, 2, 3),
    "dilation 2": ((2, 40, 79, 16, 16), 2, 2, 1.8, 2, 3),
    "offsets beyond the window": ((4, 40, 80, 16, 16), 1, 1, 5.0, 2, 3),
    "integer offsets": ((4, 40, 80, 16, 16), 1, 1, "integer", 2, 3),
    "Co 32": ((2, 40, 80, 16, 32), 1, 1, 1.8, 2, 3),
    "C 64, window 1": ((2, 40, 80, 64, 64), 1, 1, 1.3, 1, 3),
    "C 128, window 3": ((2, 40, 80, 128, 128), 1, 1, 3.5, 3, 3),
    "window 8": ((2, 40, 80, 16, 16), 1, 1, 9.0, 8, 3),
    "window 24, no halo": ((1, 12, 40, 16, 16), 1, 1, 26.0, 24, 3),
    "tile edges": ((3, 17, 33, 16, 16), 1, 1, 1.8, 2, 3),
    "C 40, Co 24": ((2, 20, 50, 40, 24), 1, 1, 1.8, 2, 3),
    "C 6, Co 5": ((2, 13, 17, 6, 5), 1, 1, 1.8, 2, 3),
    "k 5, Co 32": ((1, 20, 40, 8, 32), 2, 1, 1.8, 2, 5),
    # ResSubmoduleAttention's deformable bottleneck (phase 20)
    "C 256, Co 256": (DEFORM_RES_SHAPE, 1, 1, 1.8, 2, 3),
}


def deform_inputs(rng, shape, scale, k=3):
    """x, offsets, mask and weight [k*k C, Co] (scaled by 1/sqrt(k*k C))
    for deform_conv_fused on the card."""
    B_, H_, W_, C, Co = shape
    K = k * k
    if scale == "integer":
        off = rng.choice(np.array([0.0, 0.0, 1.0, -1.0, 2.0, -2.0, 3.0]),
                         size=(B_, H_, W_, K, 2))
    else:
        off = rng.uniform(-scale, scale, (B_, H_, W_, K, 2))
    mask = rng.random((B_, H_, W_, K))
    return (randn(rng, B_, H_, W_, C),
            torch.from_numpy(off.astype(np.float32)).cuda(),
            torch.from_numpy(mask.astype(np.float32)).cuda(),
            randn(rng, K * C, Co) / np.sqrt(K * C))


def check_deform_kernel(ops, rng) -> float:
    """Phase 3, deform_sample: the fused kernel against the plain windowed
    form on float64 copies, and bit-equal to itself on a second call;
    returns the largest absolute error."""
    # float32 sums of K taps x 4 corners x C products (the contraction in
    # 3xTF32, each tap's sum folded into a float32 total); relative to the
    # largest |out|
    rtol = 1e-5
    worst = 0.0
    print("deform_sample vs the plain windowed form in float64:", flush=True)
    for label, (shape, pad, dil, scale, window, k) in DEFORM_CASES.items():
        x, off, mask, w = deform_inputs(rng, shape, scale, k)
        n = ops.deform_conv_fused.launches
        got = ops.deform_conv_fused(x, off, mask, w, k, pad, dil, window)
        again = ops.deform_conv_fused(x, off, mask, w, k, pad, dil, window)
        torch.cuda.synchronize()
        if ops.deform_conv_fused.launches != n + 2:
            raise SmokeFailure(f"deform_sample {label}: no launch counted")
        if not torch.equal(got, again):
            raise SmokeFailure(f"deform_sample {label}: a second call gave "
                               "other bits")
        want = ops.modulated_deform_conv_windowed(
            x.double(), off.double(), mask.double(), w.double(),
            kernel_size=k, padding=pad, dilation=dil, window=window)
        top = want.abs().max().item()
        worst = max(worst, compare(
            f"deform_sample {label} {shape} k {k} pad {pad} dil {dil} window "
            f"{window} (largest |out| {top:.2f})", got, want, rtol * top))
        del x, off, mask, w, got, again, want
    return worst


def s2_inputs(rng, B_, H_, W_, C, Co):
    """x, w, b for conv2d_fused_s2: weights scaled by 1/sqrt(9 C)."""
    return (randn(rng, B_, H_, W_, C), randn(rng, 3, 3, C, Co) / np.sqrt(9 * C),
            0.1 * randn(rng, Co))


def check_s2_kernel(ops, rng) -> float:
    """Phase 3, conv2d_s2: conv2d_fused_s2 with and without ReLU against
    the plain version on float64 copies, at RAFT's six stride-2 sites and
    at edge shapes; its gradient (autograd of the plain version, cuDNN in
    float32 with TF32 off) against float64 autograd. Returns the largest
    absolute error of y."""
    torch.backends.cudnn.allow_tf32 = False
    # 3xTF32 products (each float32 operand split into a TF32 big part and a
    # small rest), summed per 8-channel chunk on the tensor cores and folded
    # into float32 totals, in another order than float64's: relative to the
    # largest |y| (or gradient)
    rtol = 1e-5
    worst = 0.0
    print("conv2d_s2 vs plain in float64 (TF32 off):", flush=True)
    for shape in list(RAFT_S2_CONVS.values()) + EDGE_S2_CONVS:
        x, w, b = s2_inputs(rng, *shape)
        want = ops.conv3x3_s2_plain(x.double(), w.double(), b.double())
        top = want.abs().max().item()
        for relu in (False, True):
            got = ops.conv2d_fused_s2(x, w, b, relu)
            worst = max(worst, compare(
                f"conv2d_s2 {'relu' if relu else 'bare'} {shape}", got,
                torch.relu(want) if relu else want, rtol * top))
            del got
        del x, w, b, want
    x, w, b = s2_inputs(rng, *EDGE_S2_CONVS[0])
    g = randn(rng, 2, 10, 24, 24)
    got = [a.clone().requires_grad_(True) for a in (x, w, b)]
    ops.conv2d_fused_s2(*got, True).backward(g)
    ref = [a.double().requires_grad_(True) for a in (x, w, b)]
    ops.conv3x3_s2_plain(*ref, True).backward(g.double())
    for k, a, r in zip("xwb", got, ref):
        compare(f"conv2d_s2 gradient d{k} {EDGE_S2_CONVS[0]}", a.grad,
                r.grad, rtol * r.grad.abs().max().item())
    torch.backends.cudnn.allow_tf32 = True
    return worst


def gather_inputs(rng):
    """The probe's shape: img [8640, 64] and int32 row indices in range,
    constant along each row (as the probe's) or not."""
    img = randn(rng, 8640, 64)
    rows = rng.integers(0, 8640, (8640, 1)).astype(np.int32)
    probe = torch.from_numpy(np.broadcast_to(rows, (8640, 64)).copy()).cuda()
    free = torch.from_numpy(rng.integers(0, 8640, (8640, 64)).astype(
        np.int32)).cuda()
    return img, probe, free


def check_gather_kernel(ops, rng) -> float:
    """Phase 3, row_gather: take_rows bit-equal to the plain version at the
    probe's shape; an index out of range raises and launches nothing."""
    print("row_gather vs plain (bit-equal):", flush=True)
    img, probe, free = gather_inputs(rng)
    for label, idx in (("rows", probe), ("elements", free)):
        compare(f"row_gather {tuple(img.shape)} by {label}",
                ops.take_rows(img, idx), ops.take_rows_plain(img, idx), 0.0)
    bad = free.clone()
    bad[5, 7] = 8640
    n = ops.take_rows.launches
    try:
        ops.take_rows(img, bad)
    except IndexError as exc:
        print(f"  an index out of range raises: {exc}", flush=True)
    else:
        raise SmokeFailure("row_gather: an index out of range did not raise")
    if ops.take_rows.launches != n:
        raise SmokeFailure("row_gather: launched on an index out of range")
    return 0.0


def eval_phase(ops, rng, record, name: str = "LowCNN_gru",
               key: str = "eval", **model_kw) -> dict:
    """Phases 4, 6, 8 and 8b: the eval forward of LowCNN model ``name``
    (built with ``model_kw``) at full size; returns its launch counts."""
    from stereoformer_tpu_torch.models import get_model

    H8, W8, D = H // 8, W // 8, model_kw.get("max_disp", 192) // 8
    outputs, counts = LOWCNN[name]
    print(f"{name}{model_kw or ''} eval {H}x{W} B={B} iters={ITERS} "
          f"float32:", flush=True)
    model = get_model(name, device="cuda", **model_kw)
    left = randn(rng, B, H, W, 3)
    right = randn(rng, B, H, W, 3)

    def forward():
        with torch.inference_mode():
            return model(left, right, iters=ITERS)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    out = forward()
    launches = read_counts(ops)
    print(f"  launches in one forward: {launches}", flush=True)
    check_launches(f"{name} eval", launches, **counts)
    disps = out["disparities"]
    if out["disp_low"].shape != (B, H8, W8, 1) or len(disps) != outputs:
        raise SmokeFailure("unexpected output structure")
    for d in disps:
        if d.shape != (B, H, W, 1):
            raise SmokeFailure(f"disparity shape {tuple(d.shape)}")
    stacked = torch.stack(disps)
    lo, hi = stacked.min().item(), stacked.max().item()
    finite = bool(torch.isfinite(stacked).all()) and bool(
        torch.isfinite(out["disp_low"]).all())
    # the GRU's, the fixed and the variance refiners' candidates (which
    # collapse to the current disparity where their range leaves [0, D-1)),
    # and soft-argmin's expectation, lie in [0, D-1] coarse px; the convex
    # upsample blends 8x of them with zero padding at the border. The
    # learned bounds' candidates lie between the bounds: the supervised
    # variant clamps them to [0, D]; the unsupervised one takes the offset
    # net's two outputs as they come (both >= 0, in either order), so its
    # refined disparity has no upper limit. Its lower limit is 0 up to
    # float32 rounding of the candidates' steps.
    top = {"LowCNN_dynamic": float("inf"),
           "LowCNN_dynamic_supervised": 8 * D}.get(name, 8 * (D - 1))
    first_hi = disps[0].max().item()
    print(f"  outputs finite={finite}, range {lo:.3f}..{hi:.3f} px; the "
          f"first output's largest {first_hi:.3f} px", flush=True)
    if (not finite or lo < -1e-3 or hi > top + 1e-3
            or first_hi > 8 * (D - 1) + 1e-3):
        raise SmokeFailure(f"outputs not finite or out of [0, {top}]")
    del out, disps, stacked

    rec = {"peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        ms = time_ms(forward, reps=10)
        k = "tf32_convs" if tf32 else "strict_f32"
        rec[k] = {"ms_per_batch": ms, "pairs_per_s": B / ms * 1e3}
        print(f"  {k} (cudnn.allow_tf32={tf32}, matmul allow_tf32="
              f"{torch.backends.cuda.matmul.allow_tf32}): {ms:.2f} ms/batch, "
              f"{B / ms * 1e3:.2f} pairs/s", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    print(f"  peak memory {rec['peak_mem_gb']:.2f} GB", flush=True)
    # where one forward's device time goes (profiler, informative)
    rec["profile"] = profile(forward, f"{name} forward")
    record[key] = rec
    return launches


def train_batch(seed: int, batch: int, h: int, w: int) -> dict:
    trng = np.random.default_rng(seed)
    shape = (batch, h, w)
    return {"img_left": randn(trng, *shape, 3),
            "img_right": randn(trng, *shape, 3),
            "gt_disp": torch.from_numpy(
                (40 + 10 * trng.standard_normal(shape + (1,)))
                .astype(np.float32)).cuda()}


def train_phase(ops, batch: int, record, name: str = "LowCNN_gru",
                loss: str = "sequence", profile_it: bool = False) -> dict:
    """Phases 5, 7 and 8: the train step of LowCNN model ``name`` at full
    size with ``batch`` pairs and ``loss``; returns its launch counts per
    step."""
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.train import (
        Amsgrad,
        TrainState,
        compute_loss,
        make_train_step,
    )

    print(f"{name} train step {TRAIN_H}x{TRAIN_W} B={batch} "
          f"iters={ITERS} {loss} loss AMSGrad lr {LR:g} float32:",
          flush=True)
    torch.backends.cudnn.allow_tf32 = True
    model = get_model(name, device="cuda")
    tx = Amsgrad(LR)
    state = TrainState.create(model, tx)
    step = make_train_step(tx, loss, iters=ITERS)
    data = train_batch(3, batch, TRAIN_H, TRAIN_W)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    state, m = step(state, data)
    launches = read_counts(ops)
    print(f"  launches in one step: {launches}", flush=True)
    check_launches(f"{name} train step", launches, **train_launches(name))
    curve = [float(m["loss"])]
    for _ in range(4):
        state, m = step(state, data)
        curve.append(float(m["loss"]))
    print(f"  loss over 5 steps on one batch: "
          f"{', '.join(f'{x:.4f}' for x in curve)}; grad_norm "
          f"{float(m['grad_norm']):.4f}", flush=True)
    if not np.all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise SmokeFailure(f"loss not finite or not falling: {curve}")
    # over the 5 steps with TF32 convs; the strict-float32 steps below may
    # pick cuDNN algorithms with other workspaces
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def one_step():
        step(state, data)

    out = {"loss_curve": curve, "launches": launches}
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        ms = time_ms(one_step, reps=8 if tf32 else 4, warmup=1)
        key = "tf32_convs" if tf32 else "strict_f32"
        out[key] = {"ms_per_step": ms, "pairs_per_s": batch / ms * 1e3}
        print(f"  {key}: {ms:.2f} ms/step, {batch / ms * 1e3:.2f} pairs/s",
              flush=True)
    torch.backends.cudnn.allow_tf32 = True
    out["peak_mem_gb"] = peak_gb
    out["peak_mem_gb_with_strict_f32"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  peak memory {peak_gb:.2f} GB (TF32 convs), "
          f"{out['peak_mem_gb_with_strict_f32']:.2f} GB with the strict "
          f"float32 steps", flush=True)

    # the step in parts (TF32 convs): forward and loss; forward, loss and
    # backward; the optimizer alone
    params = dict(model.named_parameters())
    grads = {k: p.grad for k, p in params.items()}

    def forward_loss():
        o = model(data["img_left"], data["img_right"], iters=ITERS)
        return compute_loss(loss, o, data["gt_disp"])

    parts = {"forward_loss": forward_loss,
             "forward_backward": lambda: forward_loss().backward(),
             "optimizer": lambda: tx.step(state.opt_state, params, grads)}
    out["parts_ms"] = {k: time_ms(fn, reps=4, warmup=1)
                       for k, fn in parts.items()}
    print("  parts of a step: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in out["parts_ms"].items()), flush=True)
    if profile_it:
        out["profile"] = profile(one_step, f"{name} train step")
    prefix = "" if name == "LowCNN_gru" else name + "_"
    record[f"{prefix}train_b{batch}"] = out
    return launches


def dynamic_equal_step(ops, record) -> dict:
    """Phase 7, the unsupervised variant: one LowCNN_dynamic train step with
    the "equal" loss (its trainer's default) at 320x640, B=4: a finite
    loss, launch counts as the supervised step's."""
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.train import Amsgrad, TrainState, make_train_step

    print(f"LowCNN_dynamic train step {TRAIN_H}x{TRAIN_W} B=4 equal loss "
          f"AMSGrad lr {LR:g} float32:", flush=True)
    model = get_model("LowCNN_dynamic", device="cuda")
    tx = Amsgrad(LR)
    reset_counts(ops)
    _, m = make_train_step(tx, "equal", iters=ITERS)(
        TrainState.create(model, tx), train_batch(3, 4, TRAIN_H, TRAIN_W))
    launches = read_counts(ops)
    loss = float(m["loss"])
    print(f"  launches in one step: {launches}; loss {loss:.4f}, grad_norm "
          f"{float(m['grad_norm']):.4f}", flush=True)
    check_launches("LowCNN_dynamic train step", launches,
                   **train_launches("LowCNN_dynamic"))
    if not np.isfinite(loss):
        raise SmokeFailure(f"LowCNN_dynamic loss not finite: {loss}")
    record["LowCNN_dynamic_equal_step"] = {"loss": loss,
                                           "launches": launches}
    return launches


def raft_eval_phase(ops, rng, batch: int, record,
                    profile_it: bool = False) -> dict:
    """Phase 9: RAFT_Stereo eval at full size with ``batch`` pairs; returns
    its launch counts per forward."""
    from stereoformer_tpu_torch.models import get_model

    print(f"RAFT_Stereo eval {H}x{W} B={batch} iters={ITERS} test_mode "
          f"float32:", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    model = get_model("RAFT_Stereo", device="cuda")
    left = randn(rng, batch, H, W, 3)
    right = randn(rng, batch, H, W, 3)

    def forward():
        with torch.inference_mode():
            return model(left, right, iters=ITERS, test_mode=True)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    out = forward()
    launches = read_counts(ops)
    print(f"  launches in one forward: {launches}", flush=True)
    check_launches("RAFT eval", launches, conv2d_fused=14)
    disps = out["disparities"]
    if (len(disps) != 1 or disps[0].shape != (batch, H, W, 1)
            or out["disp_low"].shape != (batch, H // 4, W // 4, 1)):
        raise SmokeFailure("unexpected RAFT output structure")
    finite = bool(torch.isfinite(disps[0]).all()) and bool(
        torch.isfinite(out["disp_low"]).all())
    print(f"  outputs finite={finite}, range {disps[0].min().item():.3f}.."
          f"{disps[0].max().item():.3f} px", flush=True)
    if not finite:
        raise SmokeFailure("RAFT outputs not finite")
    del out, disps
    rec = {"peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"  peak memory {rec['peak_mem_gb']:.2f} GB", flush=True)
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        ms = time_ms(forward, reps=4 if batch <= 2 else 2, warmup=1)
        key = "tf32_convs" if tf32 else "strict_f32"
        rec[key] = {"ms_per_batch": ms, "pairs_per_s": batch / ms * 1e3}
        print(f"  {key} (cudnn.allow_tf32={tf32}; conv2d_fused is float32 "
              f"either way): {ms:.2f} ms/batch, {batch / ms * 1e3:.2f} "
              f"pairs/s", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    if profile_it:
        rec["profile"] = profile(forward, f"RAFT eval forward B={batch}")
    record[f"raft_eval_b{batch}"] = rec
    return launches


def raft_train_setup(dtype=None, batch: int = RAFT_TRAIN_B, **options):
    """The RAFT train protocol on the card: RAFT_Stereo with random weights
    from the torch seed as it stands (computing in ``dtype``: float32, or
    bf16; with the model's ``options``), AMSGrad at RAFT_LR, the sequence
    loss over ITERS iterations and one batch of ``batch`` pairs (the
    protocol's RAFT_TRAIN_B) at RAFT_TRAIN_H x RAFT_TRAIN_W from seed 4.
    Returns (model, tx, state, step, data). ``scripts/time_raft_step.py``
    times the same protocol."""
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.train import (
        Amsgrad,
        TrainState,
        make_train_step,
    )

    model = get_model("RAFT_Stereo", device="cuda", dtype=dtype, **options)
    tx = Amsgrad(RAFT_LR)
    state = TrainState.create(model, tx)
    step = make_train_step(tx, "sequence", iters=ITERS)
    data = train_batch(4, batch, RAFT_TRAIN_H, RAFT_TRAIN_W)
    return model, tx, state, step, data


def raft_train_phase(ops, record) -> dict:
    """Phase 10: the RAFT train step at full size; returns its launch counts
    per step."""
    from stereoformer_tpu_torch.train import compute_loss

    Bt, Ht, Wt = RAFT_TRAIN_B, RAFT_TRAIN_H, RAFT_TRAIN_W
    print(f"RAFT_Stereo train step {Ht}x{Wt} B={Bt} iters={ITERS} sequence "
          f"loss AMSGrad lr {RAFT_LR:g} float32:", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    model, tx, state, step, data = raft_train_setup()

    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    ops.conv2d_fused.grad_copies = 0
    state, m = step(state, data)
    launches = read_counts(ops)
    copies = ops.conv2d_fused.grad_copies
    print(f"  launches in one step: {launches}; cotangents copied to NHWC by "
          f"the fused conv's backward: {copies}", flush=True)
    # 14 routed sites: each launches the forward and, in the backward, the
    # dx conv and the dw kernel
    check_launches("RAFT train step", launches, conv2d_fused=28,
                   conv2d_dw=14)
    curve = [float(m["loss"])]
    for _ in range(4):
        state, m = step(state, data)
        curve.append(float(m["loss"]))
    print(f"  loss over 5 steps on one batch: "
          f"{', '.join(f'{x:.4f}' for x in curve)}; grad_norm "
          f"{float(m['grad_norm']):.4f}", flush=True)
    if not np.all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise SmokeFailure(f"RAFT loss not finite or not falling: {curve}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def one_step():
        step(state, data)

    out = {"loss_curve": curve, "launches": launches,
           "grad_copies_per_step": copies}
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        ms = time_ms(one_step, reps=4 if tf32 else 2, warmup=1)
        key = "tf32_convs" if tf32 else "strict_f32"
        out[key] = {"ms_per_step": ms, "pairs_per_s": Bt / ms * 1e3}
        print(f"  {key} (conv2d_fused and conv2d_dw are float32 either way): "
              f"{ms:.2f} ms/step, {Bt / ms * 1e3:.2f} pairs/s", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    out["peak_mem_gb"] = peak_gb
    print(f"  peak memory {peak_gb:.2f} GB (TF32 convs)", flush=True)

    params = dict(model.named_parameters())
    grads = {k: p.grad for k, p in params.items()}

    def forward_loss():
        o = model(data["img_left"], data["img_right"], iters=ITERS)
        return compute_loss("sequence", o, data["gt_disp"])

    parts = {"forward_loss": forward_loss,
             "forward_backward": lambda: forward_loss().backward(),
             "optimizer": lambda: tx.step(state.opt_state, params, grads)}
    out["parts_ms"] = {k: time_ms(fn, reps=2, warmup=1)
                       for k, fn in parts.items()}
    print("  parts of a step: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in out["parts_ms"].items()), flush=True)
    out["profile"] = profile(one_step, f"RAFT train step B={Bt}",
                             kernels=("conv3x3_kernel", "moments_kernel",
                                      "dw_kernel", "dw_reduce_kernel"))
    record["raft_train"] = out
    del state, model, data
    return launches


def s2_path(ops, rng, record) -> dict:
    """Phase 11: conv2d_fused_s2 at RAFT's six stride-2 sites, as the
    encoders would call it (no ReLU: a norm follows each): launch counts,
    shapes and finiteness."""
    print("conv2d_fused_s2 at RAFT's stride-2 sites (B=2, 576x960):",
          flush=True)
    reset_counts(ops)
    for where, shape in RAFT_S2_CONVS.items():
        B_, H_, W_, _, Co = shape
        x, w, b = s2_inputs(rng, *shape)
        y = ops.conv2d_fused_s2(x, w, b)
        if y.shape != (B_, H_ // 2, W_ // 2, Co) or not bool(
                torch.isfinite(y).all()):
            raise SmokeFailure(f"conv2d_s2 {where}: shape {tuple(y.shape)} "
                               f"or values not finite")
        del x, w, b, y
    launches = read_counts(ops)
    print(f"  launches: {launches}", flush=True)
    check_launches("conv2d_s2 at RAFT's sites", launches,
                   conv2d_s2=len(RAFT_S2_CONVS))
    record["conv2d_s2_sites"] = {"launches": launches}
    return launches


def gather_probe_path(ops, record) -> dict:
    """Phase 11: the row-gather probe as a user runs it
    (``python -m stereoformer_tpu_torch.scripts.gather_probe``): one launch,
    the result checked against numpy by the probe itself."""
    from stereoformer_tpu_torch.scripts import gather_probe

    print("row-gather probe:", flush=True)
    reset_counts(ops)
    out = gather_probe.main([])
    launches = read_counts(ops)
    print(f"  launches: {launches}", flush=True)
    check_launches("gather probe", launches, row_gather=1)
    if out.device.type != "cuda":
        raise SmokeFailure("gather probe did not run on the card")
    record["gather_probe"] = {"launches": launches}
    return launches


def kernel_rows(ops, rng, err, launches, record) -> list:
    """Phase 12: each kernel at its main path's shapes: device time per
    launch (and per call of its wrapper, host overhead included), the plain
    version's device time, the bound; rows 1-3 also at D = 96 (S = 33),
    past the old kernels' limits."""
    from stereoformer_tpu_torch import kernels

    dev = torch.device("cuda")
    D, S, C = 24, 21, 256
    eval_shape = (B, H // 8, W // 8)
    train_shape = (4, TRAIN_H // 8, TRAIN_W // 8)

    def corr_work(shape, d, _):
        feats_l, feats_r = randn(rng, *shape, C), randn(rng, *shape, C)
        npix = int(np.prod(shape))
        band = shape[0] * shape[1] * (d * shape[2] - d * (d - 1) // 2)
        kern = lambda: ops.correlation_volume(feats_l, feats_r, d)  # noqa: E731
        return ((2 * npix * C + npix * d) * 4, 2 * C * band, kern,
                lambda: ops.correlation_volume_plain(feats_l, feats_r, d),
                50, 5, kern)

    def local_work(shape, d, s):
        vol = randn(rng, *shape, d)
        cands = torch.from_numpy(edge_candidates(rng, shape + (s,), d)).to(dev)
        npix = int(np.prod(shape))
        # ~20 operations per candidate: clip, floor, two hat taps, max, exp,
        # sums (csrc/local_soft_argmin.cu)
        kern = lambda: ops.local_soft_argmin(vol, cands)  # noqa: E731
        return (npix * (d + s + 1) * 4, 20 * npix * s, kern,
                lambda: ops.local_soft_argmin_plain(vol, cands), 200, 20, kern)

    def bwd_work(shape, d, s):
        vol = randn(rng, *shape, d).requires_grad_(True)
        cands = torch.from_numpy(edge_candidates(rng, shape + (s,), d)).to(dev)
        cands.requires_grad_(True)
        g = randn(rng, *shape, 1)
        out = ops.local_soft_argmin(vol, cands)
        npix = int(np.prod(shape))
        dvol, dcand = torch.empty_like(vol), torch.empty_like(cands)

        def launch():
            # the kernel alone, as _LocalSoftArgmin.backward launches it (an
            # autograd backward cannot be captured from a side stream)
            kernels.launch("local_soft_argmin_bwd", dev, vol.data_ptr(),
                           cands.data_ptr(), g.data_ptr(), dvol.data_ptr(),
                           dcand.data_ptr(), npix, d, s)

        # reads vol, cand, g; writes dvol, dcand. ~35 operations per
        # candidate: the forward's, then the softmax VJP and four hat terms
        # (the kernel's gather of dvol tests D hats per candidate more)
        return (npix * (2 * d + 2 * s + 1) * 4, 35 * npix * s,
                lambda: torch.autograd.grad(out, (vol, cands), g,
                                            retain_graph=True),
                lambda: ops.local_soft_argmin_backward_plain(
                    vol.detach(), cands.detach(), g), 200, 20, launch)

    # the forward kernels at the eval shapes (slice 1's main path), at the
    # train shapes and at the eval shapes with D = 96, S = 33; the backward
    # at the train shapes, the eval shapes and the train shapes with D = 96
    work = {"corr_band": (corr_work, eval_shape, train_shape, eval_shape),
            "local_soft_argmin": (local_work, eval_shape, train_shape,
                                  eval_shape),
            "local_soft_argmin_bwd": (bwd_work, train_shape, eval_shape,
                                      train_shape)}
    rows, extra = [], {}
    for name, (make, main_shape, other_shape, wide_shape) in work.items():
        times = {}
        for shape, d, s in ((main_shape, D, S), (other_shape, D, S),
                            (wide_shape, 96, 33)):
            nbytes, nops, kern, plain, reps, plain_reps, timed = make(
                shape, d, s)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / F32_FLOPS_PER_S * 1e3
            # each timed function launches its own kernel only
            times[(shape, d, s)] = t = {
                "ms": graph_ms(timed, reps),
                "call_ms": time_ms(kern, reps),
                "plain_ms": graph_ms(plain, plain_reps),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "mb": nbytes / 1e6,
            }
            print(f"  {name} {shape} D={d} S={s}: {t['ms'] * 1e3:.1f} us on "
                  f"the device (bound {t['bound_ms'] * 1e3:.2f} us, "
                  f"{t['mb']:.2f} MB), {t['call_ms'] * 1e3:.1f} us per "
                  f"wrapper call, plain {t['plain_ms'] * 1e3:.1f} us",
                  flush=True)
        main = times[(main_shape, D, S)]
        route, source, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": launches["train_step"][name],
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": err[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": list(main_shape),
        })
        extra[name] = {f"{list(k[0])} D={k[1]} S={k[2]}": v
                       for k, v in times.items()}
    record["kernel_times"] = extra

    # corr_band's backward, plain torch ops, at the train shapes: reads L, R
    # and the cotangent, writes dL and dR
    shape = train_shape
    left, right = randn(rng, *shape, C), randn(rng, *shape, C)
    g = randn(rng, *shape, D)
    npix = int(np.prod(shape))
    nbytes = (4 * npix * C + npix * D) * 4
    ms = graph_ms(lambda: ops.correlation_volume_backward(left, right, g), 20)
    record["corr_band_backward"] = {
        "shape": list(shape), "ms": ms, "mb": nbytes / 1e6,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    print(f"  corr_band backward (torch ops) {shape}: {ms * 1e3:.1f} us on "
          f"the device (bound {nbytes / HBM_BYTES_PER_S * 1e6:.1f} us, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return rows


def conv_row(ops, rng, err, launches, record) -> dict:
    """Phase 12, conv2d_fused at RAFT's four eval shapes: device time of the
    variant each encoder runs most (the feature net's prologue+stats, the
    context net's prologue), the plain version's (its conv in cuDNN with
    TF32 off, float32 as the kernel), cuDNN's F.conv2d with bias (TF32 off
    and on), and the bounds: bytes (x read, y written) or float32
    operations at the float32 rate (``bound_ms``), three TF32 products per
    float32 product at the TF32 rate (the kernel's design,
    ``bound_tf32x3_ms``) and one TF32 product (``bound_tf32_ms``); the
    blocks of each site's grid."""
    from stereoformer_tpu_torch import kernels

    times = {where: fused_site(ops, rng, where, *shape)
             for where, shape in RAFT_CONVS.items()}
    dx = dx_times(ops, rng)
    torch.backends.cudnn.allow_tf32 = True
    record["kernel_times"]["conv2d_fused"] = times
    record["kernel_times"]["conv2d_fused_dx"] = dx
    main = times["fnet layer1"]
    route, source, replaces = KERNELS["conv2d_fused"]
    return {
        "name": "conv2d_fused", "route": route, "source": source,
        "replaces": replaces,
        "launches": launches["raft_train_step"]["conv2d_fused"],
        "launches_by_path": {p: c["conv2d_fused"] for p, c in launches.items()},
        "max_abs_err": err["conv2d_fused"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library_tf32_ms": main["library_tf32_ms"],
        "bound_tf32x3_ms": main["bound_tf32x3_ms"],
        "bound_tf32_ms": main["bound_tf32_ms"],
        "share_of_design_bound": main["share_of_design_bound"],
        "ratio_to_cudnn_f32": main["ratio_to_cudnn_f32"],
        "shape": main["shape"], "variant": main["variant"],
        "dx": dx["fnet layer1"], "ptxas": kernels.ptxas_usage("conv2d_fused"),
    }


def fused_site(ops, rng, where: str, B_: int, H_: int, W_: int, C: int,
               Co: int = None) -> dict:
    """conv2d_fused at one site [B_, H_, W_, C] -> Co (C where not given),
    TF32 off: the device time of the variant the encoder runs there (the
    feature net's prologue+stats, the context net's prologue), its plain
    version's, cuDNN's F.conv2d with bias (TF32 off and on), and the bounds
    (``conv_row``)."""
    import torch.nn.functional as F

    from stereoformer_tpu_torch.ops.fused_conv import fused_blocks

    Co = C if Co is None else Co
    torch.backends.cudnn.allow_tf32 = False
    x, w, b, s, t, r = conv_inputs(rng, B_, H_, W_, C, Co)
    variant = "prologue+stats" if where.startswith("fnet") else "prologue"
    kern, kw = conv_calls(ops, x, w, b, s, t, r)[variant]
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    nbytes = (B_ * H_ * W_ * (C + Co) + 9 * C * Co + Co) * 4
    nops = 2 * 9 * C * Co * B_ * H_ * W_
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS_PER_S * 1e3
    row = {"variant": variant, "shape": [B_, H_, W_, C, Co],
           "gflop": nops / 1e9, "mb": nbytes / 1e6,
           "ms": graph_ms(kern, 10),
           "call_ms": time_ms(kern, 10),
           "plain_ms": graph_ms(
               lambda: ops.conv3x3_plain(x, w, b, **kw), 5),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_tf32x3_ms": tf32x3_bound_ms(nbytes, nops),
           "bound_tf32_ms": max(t_bytes,
                                nops / TF32_FLOPS_PER_S * 1e3),
           "blocks": fused_blocks(B_, H_, W_, Co)}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        key = "library_tf32_ms" if tf32 else "library_ms"
        row[key] = graph_ms(lambda: F.conv2d(xc, wc, b, padding=1), 10)
    torch.backends.cudnn.allow_tf32 = False
    print_conv_row(f"conv2d_fused {variant}", where, row, nops,
                   "F.conv2d+bias")
    return row


def dx_times(ops, rng) -> dict:
    """Phase 12, conv2d_fused as the backward's dx conv at RAFT's four
    training shapes (``dx_site``)."""
    return {where: dx_site(ops, rng, where, *shape)
            for where, shape in RAFT_TRAIN_CONVS.items()}


def dx_site(ops, rng, where: str, B_: int, H_: int, W_: int, C: int,
            Co: int = None) -> dict:
    """conv2d_fused as the backward's dx conv of a C -> Co conv (Co = C
    where not given) at [B_, H_, W_]: the cotangent [.., Co] with the
    flipped, io-transposed weights and no bias, -> [.., C]. Its device
    time, the plain version's, cuDNN's conv2d_input for the same gradient
    (TF32 off and on), and the bounds (float32, 3xTF32 and one TF32 pass,
    as in ``conv_row``)."""
    from torch.nn.grad import conv2d_input

    from stereoformer_tpu_torch.ops.fused_conv import fused_blocks

    Co = C if Co is None else Co
    g = randn(rng, B_, H_, W_, Co)
    w = randn(rng, 3, 3, C, Co) / np.sqrt(9 * C)
    w_rot = w.flip((0, 1)).transpose(2, 3).contiguous()
    zero = torch.zeros(C, device="cuda")
    gc = g.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    nbytes = (B_ * H_ * W_ * (C + Co) + 9 * C * Co) * 4
    nops = 2 * 9 * C * Co * B_ * H_ * W_
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS_PER_S * 1e3

    def kern():
        return ops.conv2d_fused(g, w_rot, zero, None, False)

    row = {"shape": [B_, H_, W_, C, Co], "gflop": nops / 1e9,
           "mb": nbytes / 1e6, "ms": graph_ms(kern, 10),
           "call_ms": time_ms(kern, 10),
           "plain_ms": graph_ms(
               lambda: ops.conv3x3_plain(g, w_rot, zero), 5),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_tf32x3_ms": tf32x3_bound_ms(nbytes, nops),
           "bound_tf32_ms": max(t_bytes, nops / TF32_FLOPS_PER_S * 1e3),
           "blocks": fused_blocks(B_, H_, W_, C)}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        key = "library_tf32_ms" if tf32 else "library_ms"
        row[key] = graph_ms(
            lambda: conv2d_input((B_, C, H_, W_), wc, gc, padding=1), 10)
    torch.backends.cudnn.allow_tf32 = False
    print_conv_row("conv2d_fused as dx", where, row, nops, "conv2d_input")
    return row


def tf32x3_bound_ms(nbytes: float, nops: float) -> float:
    """The bound of a 3xTF32 design: the bytes at the HBM rate, or three
    TF32 products per float32 product at the TF32 tensor-core rate."""
    return max(nbytes / HBM_BYTES_PER_S, 3 * nops / TF32_FLOPS_PER_S) * 1e3


def print_conv_row(name, where, row, nops, library) -> None:
    """Print one site of a 3xTF32 conv kernel (conv2d_fused, conv2d_dw,
    conv2d_s2) and add its share of the 3xTF32 bound and its ratio to
    cuDNN's float32 call to ``row``."""
    row["share_of_design_bound"] = row["bound_tf32x3_ms"] / row["ms"]
    row["ratio_to_cudnn_f32"] = row["ms"] / row["library_ms"]
    extra = (f" (the profiler: {row['profiler_ms']:.3f} ms)"
             if "profiler_ms" in row else "")
    print(f"  {name} {where} {row['shape']}: {row['ms']:.4f} ms on the device "
          f"({nops / row['ms'] / 1e9:.1f} TFLOP/s){extra}; bounds "
          f"{row['bound_ms']:.4f} ms float32 by {row['bound_by']}, "
          f"{row['bound_tf32x3_ms']:.4f} ms 3xTF32, "
          f"{row['bound_tf32_ms']:.4f} ms one TF32 pass, "
          f"{100 * row['share_of_design_bound']:.1f}% of the 3xTF32 bound; "
          f"{row['call_ms']:.4f} ms per wrapper call; plain "
          f"{row['plain_ms']:.4f} ms; cuDNN {library} {row['library_ms']:.4f} "
          f"ms (TF32 off, kernel/cuDNN {row['ratio_to_cudnn_f32']:.3f}), "
          f"{row['library_tf32_ms']:.4f} ms (TF32 on)", flush=True)


def dw_row(ops, rng, err, launches, record) -> dict:
    """Phase 12, conv2d_dw at RAFT's four training shapes: its device time
    (both kernels), the plain version's (nine float32 einsums), cuDNN's
    conv2d_weight for the same gradient (TF32 off and on), and the bounds:
    x and g read, dw written, or float32 operations at the float32 rate
    (``bound_ms``), three TF32 products per float32 product at the TF32
    rate (the kernel's design, ``bound_tf32x3_ms``) and one TF32 product at
    that rate (``bound_tf32_ms``)."""
    from stereoformer_tpu_torch import kernels

    times = {where: dw_site(ops, rng, where, *shape)
             for where, shape in RAFT_TRAIN_CONVS.items()}
    torch.backends.cudnn.allow_tf32 = True
    record["kernel_times"]["conv2d_dw"] = times
    main = times["fnet layer1"]
    route, source, replaces = KERNELS["conv2d_dw"]
    return {
        "name": "conv2d_dw", "route": route, "source": source,
        "replaces": replaces,
        "launches": launches["raft_train_step"]["conv2d_dw"],
        "launches_by_path": {p: c["conv2d_dw"] for p, c in launches.items()},
        "max_abs_err": err["conv2d_dw"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library_tf32_ms": main["library_tf32_ms"],
        "bound_tf32x3_ms": main["bound_tf32x3_ms"],
        "bound_tf32_ms": main["bound_tf32_ms"],
        "share_of_design_bound": main["share_of_design_bound"],
        "ratio_to_cudnn_f32": main["ratio_to_cudnn_f32"],
        "shape": main["shape"], "ptxas": kernels.ptxas_usage("conv2d_dw"),
    }


def dw_site(ops, rng, where: str, B_: int, H_: int, W_: int, C: int,
            Co: int = None) -> dict:
    """conv2d_dw at one site, x [B_, H_, W_, C] and g [.., Co] (Co = C where
    not given), TF32 off: its device time, the plain version's, cuDNN's
    conv2d_weight (TF32 off and on) and the bounds (``dw_row``)."""
    from torch.nn.grad import conv2d_weight

    Co = C if Co is None else Co
    torch.backends.cudnn.allow_tf32 = False
    x, g = randn(rng, B_, H_, W_, C), randn(rng, B_, H_, W_, Co)
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    nbytes = (B_ * H_ * W_ * (C + Co) + 9 * C * Co) * 4
    nops = 2 * 9 * C * Co * B_ * H_ * W_
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS_PER_S * 1e3

    def kern():
        return ops.conv2d_dw(x, g)

    row = {"shape": [B_, H_, W_, C, Co], "gflop": nops / 1e9,
           "mb": nbytes / 1e6, "ms": graph_ms(kern, 10),
           "call_ms": time_ms(kern, 10),
           "plain_ms": graph_ms(lambda: ops.conv2d_dw_plain(x, g), 3),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_tf32x3_ms": tf32x3_bound_ms(nbytes, nops),
           "bound_tf32_ms": max(t_bytes,
                                nops / TF32_FLOPS_PER_S * 1e3)}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        key = "library_tf32_ms" if tf32 else "library_ms"
        row[key] = graph_ms(
            lambda: conv2d_weight(xc, (Co, C, 3, 3), gc, padding=1), 10)
    torch.backends.cudnn.allow_tf32 = False
    print_conv_row("conv2d_dw", where, row, nops, "conv2d_weight")
    return row


def deform_row(ops, rng, err, launches, record) -> dict:
    """Phase 12, deform_sample at the learned bounds' eval and train shapes:
    the fused kernel's device time (one launch: x, offsets, mask and weight
    in, the output out), the plain version's (the windowed form),
    torchvision's deform_conv2d on pre-clamped offsets where torchvision
    imports (the same function), and the bounds: x, the offsets, the mask
    and the weight read once and the output written once, or 4 K C corner
    FMAs and K C Co contraction FMAs a pixel at the float32 rate
    (``bound_ms``); or the corners at the float32 rate and the contraction
    as three TF32 products at the TF32 rate, one after the other (the
    kernel's design, ``bound_tf32x3_ms``). At the train shape also the
    backward, autograd of the plain windowed form for the gradients of all
    four inputs, as the train step runs it: its kernels' device time by the
    profiler, and its time per call by CUDA events over back-to-back
    calls, host gaps included (the lowest and highest of five runs)."""
    from stereoformer_tpu_torch import kernels

    times = {where: deform_site(ops, rng, where, shape,
                                backward=where == "train")
             for where, shape in DEFORM_SHAPES.items()}
    record["kernel_times"]["deform_sample"] = times
    main = times["eval"]
    route, source, replaces = KERNELS["deform_sample"]
    return {
        "name": "deform_sample", "route": route, "source": source,
        "replaces": replaces,
        "launches": launches["dynamic_eval"]["deform_sample"],
        "launches_by_path": {p: c["deform_sample"]
                             for p, c in launches.items()},
        "max_abs_err": err["deform_sample"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "call_ms": main["call_ms"], "shape": main["shape"],
        "share_of_bound": main["share_of_bound"],
        "bound_tf32x3_ms": main["bound_tf32x3_ms"],
        "share_of_design_bound": main["share_of_design_bound"],
        "train": times["train"], "ptxas": kernels.ptxas_usage("deform_sample"),
    }


def deform_site(ops, rng, where: str, shape: tuple,
                backward: bool = False) -> dict:
    """deform_sample at one shape (B, H, W, C, Co), window 2, k = 3: the
    fused kernel's device time and tiling, the plain version's, torchvision's
    where it imports, and the bounds (``deform_row``); with ``backward``,
    also the backward's times."""
    from stereoformer_tpu_torch.ops.deform import deform_sample_launch

    try:
        import torchvision.ops as tv_ops
    except ImportError:
        tv_ops = None
    B_, H_, W_, C, Co = shape
    x, off, mask, w = deform_inputs(rng, shape, 1.8)
    plan = {}
    deform_sample_launch(x, off, mask, w, plan=plan)
    npix, K = B_ * H_ * W_, 9
    nbytes = (npix * C + npix * 3 * K + K * C * Co + npix * Co) * 4
    corner_ops, mma_ops = 2 * 4 * K * C * npix, 2 * K * C * Co * npix
    nops = corner_ops + mma_ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS_PER_S * 1e3
    t_design = (corner_ops / F32_FLOPS_PER_S
                + 3 * mma_ops / TF32_FLOPS_PER_S) * 1e3

    def kern():
        return ops.deform_conv_fused(x, off, mask, w)

    row = {"shape": list(shape), "mb": nbytes / 1e6, "gflop": nops / 1e9,
           "ms": graph_ms(kern, 50), "call_ms": time_ms(kern, 50),
           "plain_ms": graph_ms(
               lambda: ops.modulated_deform_conv_windowed(x, off, mask,
                                                          w), 5),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
           "bound_tf32x3_ms": max(t_bytes, t_design),
           "library_ms": None, "plan": plan}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["share_of_design_bound"] = row["bound_tf32x3_ms"] / row["ms"]
    if tv_ops is not None:
        xc = x.permute(0, 3, 1, 2)
        offc = off.clamp(-2, 2).reshape(B_, H_, W_, 2 * K).permute(
            0, 3, 1, 2).contiguous()
        mc = mask.permute(0, 3, 1, 2).contiguous()
        wc = w.reshape(3, 3, C, Co).permute(3, 2, 0, 1).contiguous()

        def lib():
            return tv_ops.deform_conv2d(xc, offc, wc, padding=(1, 1),
                                        mask=mc)

        row["library_ms"] = graph_ms(lib, 20)
        row["library_max_abs_diff"] = (
            lib().permute(0, 2, 3, 1) - kern()).abs().max().item()
    bwd_text = ""
    if backward:
        leaves = [t.clone().requires_grad_(True) for t in (x, off, mask,
                                                           w)]
        y = ops.deform_conv_fused(*leaves)
        g = randn(rng, *y.shape)

        def bwd():
            return torch.autograd.grad(y, leaves, g, retain_graph=True)

        # the autograd graph of the plain form does not capture into a
        # CUDA graph: its kernels' device time by the profiler, and
        # CUDA events over back-to-back calls
        row["backward_device_ms"] = profiler_ms(bwd, 5, "")
        runs = [time_ms(bwd, 4) for _ in range(5)]
        row["backward_ms"] = float(np.median(runs))
        row["backward_ms_range"] = [min(runs), max(runs)]
        bwd_text = (f"; backward (autograd of the plain form) "
                    f"{row['backward_device_ms']:.3f} ms of device time "
                    f"a call by the profiler, {min(runs):.3f} to "
                    f"{max(runs):.3f} ms a call by events")
        del leaves, y, g
    lib_text = ("torchvision not importable" if tv_ops is None else
                f"torchvision deform_conv2d {row['library_ms'] * 1e3:.1f}"
                f" us (max |diff| {row['library_max_abs_diff']:.2e})")
    print(f"  deform_sample {where} {shape}: {row['ms'] * 1e3:.2f} us on "
          f"the device ({plan['rows']}-row tiles, {16 * plan['mt']} "
          f"pixels a warp, {plan['ts']} tap slices; bound "
          f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']}: "
          f"{row['mb']:.2f} MB, {row['gflop']:.3f} GFLOP; "
          f"{100 * row['share_of_bound']:.1f}%; 3xTF32 design bound "
          f"{row['bound_tf32x3_ms'] * 1e3:.2f} us, "
          f"{100 * row['share_of_design_bound']:.1f}%), "
          f"{row['call_ms'] * 1e3:.1f} us per wrapper call; plain "
          f"{row['plain_ms'] * 1e3:.1f} us; {lib_text}{bwd_text}",
          flush=True)
    return row


def s2_row(ops, rng, err, launches, record) -> dict:
    """Phase 12, conv2d_s2 at RAFT's six stride-2 sites: the kernel's device
    time, the plain version's (cuDNN, TF32 off), one F.conv2d with stride 2
    and bias (TF32 off and on), and the bounds: x read, w and b read, y
    written, or float32 operations at the float32 rate (``bound_ms``) and
    three TF32 products per float32 product at the TF32 rate (the kernel's
    design, ``bound_tf32x3_ms``) and one TF32 product at that rate
    (``bound_tf32_ms``); the blocks of each site's grid."""
    import torch.nn.functional as F

    from stereoformer_tpu_torch import kernels
    from stereoformer_tpu_torch.ops.fused_conv import s2_blocks

    torch.backends.cudnn.allow_tf32 = False
    times = {}
    for where, shape in RAFT_S2_CONVS.items():
        B_, H_, W_, C, Co = shape
        x, w, b = s2_inputs(rng, *shape)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        npix = B_ * (H_ // 2) * (W_ // 2)
        nbytes = (B_ * H_ * W_ * C + 9 * C * Co + Co + npix * Co) * 4
        nops = 2 * 9 * C * Co * npix
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS_PER_S * 1e3

        def kern():
            return ops.conv2d_fused_s2(x, w, b)

        row = {"shape": list(shape), "gflop": nops / 1e9, "mb": nbytes / 1e6,
               "ms": graph_ms(kern, 10),
               "profiler_ms": profiler_ms(kern, 10, "conv3x3_s2_kernel"),
               "call_ms": time_ms(kern, 10),
               "plain_ms": graph_ms(
                   lambda: ops.conv3x3_s2_plain(x, w, b), 5),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bound_tf32x3_ms": tf32x3_bound_ms(nbytes, nops),
               "bound_tf32_ms": max(t_bytes,
                                    nops / TF32_FLOPS_PER_S * 1e3),
               "blocks": s2_blocks(B_, H_, W_, Co)}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            key = "library_tf32_ms" if tf32 else "library_ms"
            row[key] = graph_ms(
                lambda: F.conv2d(xc, wc, b, stride=2, padding=1), 10)
        torch.backends.cudnn.allow_tf32 = False
        times[where] = row
        print_conv_row("conv2d_s2", where, row, nops,
                       "F.conv2d stride 2 + bias")
        del x, w, b, xc, wc
    torch.backends.cudnn.allow_tf32 = True
    record["kernel_times"]["conv2d_s2"] = times
    main = times["fnet layer2"]
    route, source, replaces = KERNELS["conv2d_s2"]
    return {
        "name": "conv2d_s2", "route": route, "source": source,
        "replaces": replaces,
        "launches": launches["conv2d_s2_sites"]["conv2d_s2"],
        "launches_by_path": {p: c["conv2d_s2"] for p, c in launches.items()},
        "max_abs_err": err["conv2d_s2"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library_tf32_ms": main["library_tf32_ms"],
        "bound_tf32x3_ms": main["bound_tf32x3_ms"],
        "bound_tf32_ms": main["bound_tf32_ms"],
        "share_of_design_bound": main["share_of_design_bound"],
        "ratio_to_cudnn_f32": main["ratio_to_cudnn_f32"],
        "shape": main["shape"], "ptxas": kernels.ptxas_usage("conv2d_s2"),
    }


def gather_row(ops, rng, err, launches, record) -> dict:
    """Phase 12, row_gather at the probe's shape (indices constant along
    each row): the kernel's device time, the wrapper's per call (its range
    check included), the plain version's, torch.gather's on the indices as
    int64 (converted once, outside the timing), and the bound: img, idx read
    once and out written once."""
    from stereoformer_tpu_torch import kernels

    img, idx, _ = gather_inputs(rng)
    idx64 = idx.long()
    out = torch.empty_like(img)
    nbytes = 3 * img.numel() * 4

    def launch():
        # the kernel alone, as take_rows launches it after its range check
        # (a host sync, which a CUDA graph cannot capture)
        kernels.launch("row_gather", img.device, img.data_ptr(),
                       idx.data_ptr(), out.data_ptr(), *img.shape[:1],
                       *idx.shape)

    row = {"shape": list(img.shape), "mb": nbytes / 1e6,
           "ms": graph_ms(launch, 200),
           "call_ms": time_ms(lambda: ops.take_rows(img, idx), 200),
           "plain_ms": graph_ms(lambda: ops.take_rows_plain(img, idx), 50),
           "library_ms": graph_ms(lambda: torch.gather(img, 0, idx64), 200),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    print(f"  row_gather {row['shape']}: {row['ms'] * 1e3:.2f} us on the "
          f"device (bound {row['bound_ms'] * 1e3:.2f} us by bytes, "
          f"{row['mb']:.2f} MB), {row['call_ms'] * 1e3:.1f} us per wrapper "
          f"call (with its range check); plain {row['plain_ms'] * 1e3:.1f} "
          f"us; torch.gather {row['library_ms'] * 1e3:.2f} us", flush=True)
    record["kernel_times"]["row_gather"] = row
    route, source, replaces = KERNELS["row_gather"]
    return {
        "name": "row_gather", "route": route, "source": source,
        "replaces": replaces,
        "launches": launches["gather_probe"]["row_gather"],
        "launches_by_path": {p: c["row_gather"] for p, c in launches.items()},
        "max_abs_err": err["row_gather"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": "bytes", "library_ms": row["library_ms"],
        "call_ms": row["call_ms"], "shape": row["shape"],
    }


def moderate_weights(model, seed: int = 1, **kwargs) -> dict:
    """The smoke's moderate weights for ``model``, a registry name (built on
    the CPU with ``kwargs``) or a module: seeded weights
    (``weights.seeded_state_dict``, seed ``seed``) with every weight of two
    or more axes scaled to sqrt(1.25/fan-in): they keep the softmaxes
    neither flat nor one-hot; he-normal weights make them nearly one-hot,
    and float32 rounding then grows over the GRU steps. An offset
    predictor (``conv_offset_mask``, ``conv_offset``), zero in the seeded
    weights, is drawn at the same scale (offsets of about a px)."""
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.weights import seeded_state_dict

    if isinstance(model, str):
        model = get_model(model, device="cpu", **kwargs)
    sd = seeded_state_dict(model, seed=seed)
    sd = {k: v * np.sqrt(1.25 / 2.0) if v.dim() >= 2 else v
          for k, v in sd.items()}
    orng = np.random.default_rng(seed + 7)
    for k, v in sd.items():
        if k.endswith(("conv_offset_mask.weight", "conv_offset.weight")):
            fan_in = int(np.prod(v.shape[1:]))
            sd[k] = torch.from_numpy((np.sqrt(1.25 / fan_in) * orng
                                      .standard_normal(v.shape))
                                     .astype(np.float32))
    return sd


def train_step_parity(name: str, sd: dict, batch: dict, iters: int,
                      param_tol: float, min_share: float,
                      loss: str = "sequence",
                      grad_norm_rtol: float = 1e-3,
                      model_kw: dict | None = None) -> dict:
    """One train step (AMSGrad lr 1e-3) of model ``name`` from ``sd`` on the
    card and on the CPU, TF32 off: loss, EPE and gradient norm, and the
    updated parameters. AMSGrad's first step moves each parameter by ~lr
    whatever |g|: held to 2 lr everywhere, and to ``param_tol`` where the
    gradient's sign is settled (|g| above 1e-5 and above twice the two
    sides' difference), which must hold for ``min_share`` of them."""
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.train import (
        Amsgrad,
        TrainState,
        make_train_step,
    )

    stepped = {}
    for where in ("cpu", "cuda"):
        m = get_model(name, device=where, **(model_kw or {}))
        m.load_state_dict(sd)
        tx = Amsgrad(LR)
        state, metrics = make_train_step(tx, loss, iters=iters)(
            TrainState.create(m, tx), {k: v.to(where) for k, v in batch.items()})
        stepped[where] = (
            {k: float(v) for k, v in metrics.items()},
            {k: p.detach().cpu() for k, p in m.named_parameters()},
            {k: p.grad.cpu() for k, p in m.named_parameters()})
    (mc, pc, gc), (mg, pg, gg) = stepped["cpu"], stepped["cuda"]
    parity = {}
    # the loss is a mean of px errors over all pixels: relative 1e-5; the
    # gradient norm is dominated by the encoders' leaves, where ReLU inputs
    # within float32 rounding of 0 pass or block gradient differently
    # (tests/test_torch_train.py and tests/test_torch_raft_train.py measure
    # up to ~1% per leaf against JAX): relative 1e-3
    for key, rtol in (("loss", 1e-5), ("epe", 1e-5),
                      ("grad_norm", grad_norm_rtol)):
        rel = abs(mg[key] - mc[key]) / abs(mc[key])
        print(f"  {name} train step {key}: card {mg[key]:.6f}, CPU "
              f"{mc[key]:.6f}, relative {rel:.2e} (tolerance {rtol:g}) "
              f"{'ok' if rel <= rtol else 'FAIL'}", flush=True)
        if not rel <= rtol:
            raise SmokeFailure(f"{name} train step {key}: relative error {rel}")
        parity[f"train_{key}_rel"] = rel
    worst_all = worst_settled = 0.0
    n_settled = n_total = 0
    for k, p in pc.items():
        diff = (pg[k] - p).abs()
        settled = (gc[k].abs() > 1e-5) & (gc[k].abs() > 2 * (gg[k] - gc[k]).abs())
        worst_all = max(worst_all, diff.max().item())
        if settled.any():
            worst_settled = max(worst_settled, diff[settled].max().item())
        n_settled += int(settled.sum())
        n_total += settled.numel()
    share = n_settled / n_total
    ok = (worst_all <= 2 * LR + 1e-6 and worst_settled <= param_tol
          and share >= min_share)
    print(f"  {name} train step updated parameters: max diff {worst_all:.2e} "
          f"(<= 2 lr), {worst_settled:.2e} where the gradient's sign is "
          f"settled (<= {param_tol:g}, {100 * share:.2f}% of them, at least "
          f"{100 * min_share:g}%) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{name} train step: updated parameters disagree")
    parity.update({"train_param_max_diff": worst_all,
                   "train_param_settled_max_diff": worst_settled,
                   "train_param_settled_share": share})
    return parity


# the CPU port's float32 last disparity of phase 13's runs, (name, seed) ->
# tensor: phase 17 holds the CPU's bf16 against it on the same input
CPU_F32_LAST: dict = {}


def parity_vs_cpu(seed: int = 2, **model_kw) -> dict:
    """Phase 13 (phase 8b with ``model_kw``): LowCNN_gru on the card
    against the port on the CPU at 64x256, TF32 off, moderate weights
    (``moderate_weights``): the eval forward and one train step."""
    from stereoformer_tpu_torch.models import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = moderate_weights("LowCNN_gru", **model_kw)
    srng = np.random.default_rng(seed)
    li, ri = (torch.from_numpy(srng.standard_normal((2, 64, 256, 3),
                                                    dtype=np.float32))
              for _ in range(2))
    gt = torch.from_numpy(
        (40 + 10 * srng.standard_normal((2, 64, 256, 1))).astype(np.float32))

    small = {}
    for where in ("cpu", "cuda"):
        m = get_model("LowCNN_gru", device=where, **model_kw)
        m.load_state_dict(sd)
        with torch.inference_mode():
            o = m(li.to(where), ri.to(where), iters=ITERS)
        small[where] = (o["disp_low"].cpu(), o["disparities"][-1].cpu())
    if not model_kw:
        CPU_F32_LAST[("LowCNN_gru", seed)] = small["cpu"][1]
    print(f"LowCNN_gru{model_kw or ''}, card vs CPU port at 64x256, TF32 "
          f"off:", flush=True)
    parity = {
        # f32 on both, sums in other orders; the last disparity has been
        # through 12 GRU steps
        "disp_low_px": compare("eval disp_low", small["cuda"][0],
                               small["cpu"][0], 1e-3),
        "last_disparity_px": compare("eval last disparity", small["cuda"][1],
                                     small["cpu"][1], 5e-3),
    }
    parity.update(train_step_parity(
        "LowCNN_gru", sd, {"img_left": li, "img_right": ri, "gt_disp": gt},
        iters=2, param_tol=1e-6, min_share=0.95, model_kw=model_kw))
    torch.backends.cudnn.allow_tf32 = True
    return parity


def dynamic_parity_vs_cpu() -> dict:
    """Phase 13, the learned bounds: LowCNN_dynamic_supervised on the card
    (deform_sample in the forward) against the port on the CPU at 64x256,
    TF32 off, moderate weights with a nonzero offset conv: the eval outputs
    (both disparities, disp_low and the bounds) and one range_supervised
    train step."""
    from stereoformer_tpu_torch.models import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = "LowCNN_dynamic_supervised"
    sd = moderate_weights(name)
    srng = np.random.default_rng(7)
    li, ri = (torch.from_numpy(srng.standard_normal((2, 64, 256, 3),
                                                    dtype=np.float32))
              for _ in range(2))
    gt = torch.from_numpy(
        (40 + 10 * srng.standard_normal((2, 64, 256, 1))).astype(np.float32))
    outs = {}
    for where in ("cpu", "cuda"):
        m = get_model(name, device=where)
        m.load_state_dict(sd)
        with torch.inference_mode():
            o = m(li.to(where), ri.to(where))
        outs[where] = [o["disp_low"].cpu(), *(d.cpu() for d in
                                              o["disparities"]),
                       *(b.cpu() for b in o["bounds"])]
    print(f"{name}, card vs CPU port at 64x256, TF32 off:", flush=True)
    parity = {}
    # f32 on both, sums in other orders through ~25 convs and one
    # refinement: 1e-3 px, as LowCNN_gru's disp_low
    for i, label in enumerate(("disp_low", "initial disparity",
                               "refined disparity", "lower bound",
                               "upper bound")):
        parity[label.replace(" ", "_") + "_px"] = compare(
            f"eval {label}", outs["cuda"][i], outs["cpu"][i], 1e-3)
    # the gradient norm passes the sampler's offset kink (its gradient jumps
    # where an offset crosses an integer; float32 offsets of two sides
    # differ by ~1e-5 px, and one crossing moved leaves by up to 1.7%
    # against JAX, tests/test_torch_lowcnn_dynamic.py): relative 5e-3
    parity.update(train_step_parity(
        name, sd, {"img_left": li, "img_right": ri, "gt_disp": gt},
        iters=ITERS, param_tol=1e-6, min_share=0.9, loss="range_supervised",
        grad_norm_rtol=5e-3))
    torch.backends.cudnn.allow_tf32 = True
    return parity


def raft_parity_vs_cpu() -> dict:
    """Phase 13, RAFT eval: the card against the port on the CPU at 64x128,
    12 iterations, TF32 off, moderate weights as for LowCNN."""
    from stereoformer_tpu_torch.models import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = moderate_weights("RAFT_Stereo")
    srng = np.random.default_rng(5)
    li, ri = (torch.from_numpy(srng.standard_normal((2, 64, 128, 3),
                                                    dtype=np.float32))
              for _ in range(2))
    outs = {}
    for where in ("cpu", "cuda"):
        m = get_model("RAFT_Stereo", device=where)
        m.load_state_dict(sd)
        with torch.inference_mode():
            o = m(li.to(where), ri.to(where), iters=ITERS)
        outs[where] = (o["disp_low"].cpu(), o["disparities"][-1].cpu())
    CPU_F32_LAST[("RAFT_Stereo", 5)] = outs["cpu"][1]
    print("RAFT card vs CPU port at 64x128, 12 iterations, TF32 off:",
          flush=True)
    # f32 on both, the fused conv's sums in another order; the last
    # disparity has been through 12 GRU steps
    parity = {
        "disp_low_px": compare("RAFT eval disp_low", outs["cuda"][0],
                               outs["cpu"][0], 1e-3),
        "last_disparity_px": compare("RAFT eval last disparity",
                                     outs["cuda"][1], outs["cpu"][1], 5e-3),
        "disp_low_range_px": outs["cpu"][0].abs().max().item(),
    }
    torch.backends.cudnn.allow_tf32 = True
    return parity


def raft_train_parity_vs_cpu() -> dict:
    """Phase 13, RAFT training: one train step on the card (its fused convs'
    forward, dx and dw on the kernels) against the port on the CPU at
    64x128, B=2, 2 iterations, TF32 off, moderate weights. The updated
    parameters are held as tests/test_torch_raft_train.py holds the port
    against JAX (settled within 2e-6 there: 9.8e-7 measured); 90.0% of
    them were settled on an H100, so at least 85%."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    srng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(srng.standard_normal((2, 64, 128, 3),
                                                      dtype=np.float32))
             for k in ("img_left", "img_right")}
    batch["gt_disp"] = torch.from_numpy(
        (6 + 3 * srng.standard_normal((2, 64, 128, 1))).astype(np.float32))
    print("RAFT train step, card vs CPU port at 64x128, 2 iterations, TF32 "
          "off:", flush=True)
    parity = train_step_parity("RAFT_Stereo", moderate_weights("RAFT_Stereo"),
                               batch, iters=2, param_tol=2e-6, min_share=0.85)
    torch.backends.cudnn.allow_tf32 = True
    return parity


def family_parity_vs_cpu() -> dict:
    """Phase 13, the rest of the family and CrossAttentionStereo:
    LowCNN_gru2 and CrossAttentionStereo on the card against the port on
    the CPU at 64x256, TF32 off, moderate weights: the eval forward (12
    iterations) and one sequence train step (2 iterations); and the eval
    forward of LowCNN with the concat volume and the simple upsample."""
    from stereoformer_tpu_torch.models import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    srng = np.random.default_rng(9)
    li, ri = (torch.from_numpy(srng.standard_normal((2, 64, 256, 3),
                                                    dtype=np.float32))
              for _ in range(2))
    gt = torch.from_numpy(
        (40 + 10 * srng.standard_normal((2, 64, 256, 1))).astype(np.float32))
    parity, weights = {}, {}
    for label, name, kw in (
            ("LowCNN_gru2", "LowCNN_gru2", {}),
            ("LowCNN concat volume, simple upsample", "LowCNN",
             {"cost_volume": "concat", "upsample": "simple"}),
            ("CrossAttentionStereo", "CrossAttentionStereo", {})):
        weights[label] = sd = moderate_weights(name, **kw)
        outs = {}
        for where in ("cpu", "cuda"):
            m = get_model(name, device=where, **kw)
            m.load_state_dict(sd)
            with torch.inference_mode():
                o = m(li.to(where), ri.to(where), iters=ITERS)
            outs[where] = (o["disp_low"].cpu(), o["disparities"][-1].cpu())
        print(f"{label}, card vs CPU port at 64x256, TF32 off:", flush=True)
        # f32 on both, sums in other orders; the GRU's last disparity has
        # been through 12 steps
        parity[label] = {
            "disp_low_px": compare("eval disp_low", outs["cuda"][0],
                                   outs["cpu"][0], 1e-3),
            "last_disparity_px": compare("eval last disparity",
                                         outs["cuda"][1], outs["cpu"][1],
                                         5e-3)}
    for name in ("LowCNN_gru2", "CrossAttentionStereo"):
        parity[name].update(train_step_parity(
            name, weights[name],
            {"img_left": li, "img_right": ri, "gt_disp": gt}, iters=2,
            param_tol=1e-6, min_share=0.95))
    torch.backends.cudnn.allow_tf32 = True
    return parity


# phase 14: the trainer CLI's run (dummy data, the reference's train size):
# stereoformer_tpu_torch/scripts/resume_determinism.py's TRAINER_ARGS,
# dummy:32, B=4, TRAIN_H x TRAIN_W, ITERS iterations, the loss-schedule
# file, 4 decode threads.
# A resumed run against an uninterrupted one, under cuDNN's and torch's
# deterministic settings: bit-equal
RESUME_TOL = 0.0


def trainer_phase(ops, record, work: str) -> dict:
    """Phase 14: the training system through cli.train's main, as a user
    runs it; returns the first run's launch counts. Its checkpoints (290 MB
    each) go to a tree under ``work``, removed when the phase ends but for
    the first run's model_best, kept as ``work``/model_best for phase
    16."""
    print(f"trainer: cli.train LowCNN_gru dummy:32 {TRAIN_H}x{TRAIN_W} B=4 "
          f"iters={ITERS} loss_config_disp.json, deterministic:", flush=True)
    root = os.path.join(work, "train")
    try:
        launches = train_and_resume(ops, record, root)
        os.replace(os.path.join(root, "split", "model_best"),
                   os.path.join(work, "model_best"))
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_and_resume(ops, record, root: str) -> dict:
    import warnings

    from stereoformer_tpu_torch.scripts.resume_determinism import (
        TRAINER_ARGS,
        train_run,
    )
    from stereoformer_tpu_torch.train import state_diffs

    out: dict = {}
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")

            def run(name, *extra):
                return train_run(TRAINER_ARGS, root, name, *extra)

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(ops)
            t0 = time.perf_counter()
            split = run("split", "--epochs", "2")
            launches = read_counts(ops)
            out["two_epochs_s"] = time.perf_counter() - t0
            out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            resumed = run("split", "--epochs", "3", "--resume")
            whole = run("whole", "--epochs", "3")
        nondeterministic = sorted({str(w.message).splitlines()[0]
                                   for w in caught
                                   if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            cudnn

    steps = sum(h["steps"] for h in split.history)
    val_forwards = 2 * len(split.val_loader)
    print(f"  launches in 2 epochs ({steps} train steps, {val_forwards} "
          f"validation forwards): {launches}", flush=True)
    check_launches("trainer (cli.train)", launches,
                   corr_band=steps + val_forwards,
                   local_soft_argmin=ITERS * (steps + val_forwards),
                   local_soft_argmin_bwd=ITERS * steps)
    per_step = {"corr_band": 1, "local_soft_argmin": ITERS,
                "local_soft_argmin_bwd": ITERS}
    print(f"  per train step: {per_step} (the rest per validation forward)",
          flush=True)
    out["launches"], out["launches_per_step"] = launches, per_step

    curve = [h["loss"] for h in whole.history]
    print(f"  mean loss per epoch: {', '.join(f'{x:.4f}' for x in curve)}",
          flush=True)
    if not np.all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise SmokeFailure(f"trainer loss not finite or not falling: {curve}")
    names = sorted(os.listdir(os.path.join(root, "split")))
    ckpts = [n for n in names if n.startswith("LowCNN_gru_0_")]
    print(f"  checkpoints: {names}", flush=True)
    if len(ckpts) != 3 or "model_best" not in names:
        raise SmokeFailure(f"expected 3 checkpoints and model_best: {names}")

    a, b = resumed.state, whole.state
    diffs = state_diffs(a, b)
    worst = max(d["max_abs"] for d in diffs.values())
    print(f"  resumed vs uninterrupted: step {a.step} / {b.step}, count "
          f"{a.opt_state.count} / {b.opt_state.count}, largest difference "
          + ", ".join(f"{k} {v['max_abs']:.3e}" for k, v in diffs.items())
          + f" (tolerance {RESUME_TOL:g})", flush=True)
    print(f"  ops without a deterministic kernel: "
          f"{nondeterministic or 'none'}", flush=True)
    out.update(resume_max_diff=diffs, nondeterministic_ops=nondeterministic,
               loss_curve=curve)
    if (a.step, a.opt_state.count) != (b.step, b.opt_state.count) \
            or not worst <= RESUME_TOL:
        raise SmokeFailure(f"resumed run differs from the uninterrupted one "
                           f"by {worst} (tolerance {RESUME_TOL})")

    # the speed of the default settings: one more epoch of the resumed
    # trainer, then one under the profiler for the device's busy share
    last = resumed.history
    resumed.train_one_epoch(3, 0, 0)
    h = last[-1]
    ms = h["seconds"] / h["steps"] * 1e3
    bare = record.get("train_b4", {}).get("tf32_convs", {}).get("ms_per_step")
    out["epoch"] = h
    out["ms_per_step"], out["data_wait_share"] = ms, h["data_s"] / h["seconds"]
    out["bare_step_ms"] = bare
    print(f"  through the trainer: {ms:.2f} ms/step (phase 5's bare step on a "
          f"fixed batch: {bare if bare is None else f'{bare:.2f}'} ms), "
          f"waiting for data {100 * out['data_wait_share']:.1f}% of the "
          f"epoch ({1e3 * h['data_s']:.1f} ms, {1e3 * h['first_data_s']:.1f} "
          f"of it for the first batch); peak memory "
          f"{out['peak_mem_gb']:.2f} GB", flush=True)
    out["busy"] = busy = device_busy(lambda: resumed.train_one_epoch(4, 0, 0))
    print(f"  one epoch under a device-only profiler: {busy['wall_ms']:.1f} ms "
          f"wall, {busy['device_ms']:.1f} ms of device time in "
          f"{busy['gpu_events']} GPU events: busy "
          f"{100 * busy['device_ms'] / busy['wall_ms']:.0f}% of the profiled "
          f"epoch, {100 * busy['device_ms'] / (1e3 * h['seconds']):.0f}% of "
          f"the unprofiled one", flush=True)
    # one checkpoint of the whole state, as the trainer writes it an epoch
    from stereoformer_tpu_torch.train import save_checkpoint

    t0 = time.perf_counter()
    path = save_checkpoint(os.path.join(root, "timed"), resumed.state,
                           "LowCNN_gru", 0, 9, 0.0, False)
    out["checkpoint_s"] = time.perf_counter() - t0
    out["checkpoint_mb"] = os.path.getsize(path) / 1e6
    print(f"  one checkpoint (parameters, BatchNorm buffers, AMSGrad "
          f"moments): {out['checkpoint_mb']:.1f} MB in "
          f"{out['checkpoint_s']:.2f} s", flush=True)
    record["trainer"] = out
    return launches


# phase 15's tree: 32 pairs make 8 batches of 4, four times the
# prefetcher's DEPTH, so batches are handed out while later copies are
# queued and freed blocks are reused; 5 validation pairs end in a partial
# batch
FILE_PAIRS, FILE_VAL_PAIRS = 32, 5


# phase 15's tree, as SceneFlow lays its files out
SCENEFLOW_DIRS = {"left": "frames_finalpass/left",
                  "right": "frames_finalpass/right", "disp": "disparity/left"}


def write_sceneflow_tree(root: str, n: int, n_val: int) -> tuple:
    """A SceneFlow-shaped tree under ``root``: ``n`` pairs of 540x960 RGB
    PNG with PFM disparities (synthetic scenes with exact disparity) under
    ``SCENEFLOW_DIRS``, a train list of all and a val list of the first
    ``n_val``."""
    from PIL import Image

    from stereoformer_tpu_torch.data import DummyStereoDataset, write_pfm

    for d in SCENEFLOW_DIRS.values():
        os.makedirs(os.path.join(root, d), exist_ok=True)
    ds = DummyStereoDataset(length=n, height=540, width=960, max_disp=120.0,
                            seed=5)
    lines = []
    for i in range(n):
        s = ds[i]
        names = {side: f"{SCENEFLOW_DIRS[side]}/{i:04d}.png"
                 for side in ("left", "right")}
        names["disp"] = f"{SCENEFLOW_DIRS['disp']}/{i:04d}.pfm"
        for side in ("left", "right"):
            Image.fromarray(np.clip(s[f"img_{side}"], 0, 255)
                            .astype(np.uint8)).save(
                os.path.join(root, names[side]))
        write_pfm(os.path.join(root, names["disp"]), s["gt_disp"])
        lines.append(f"{names['left']} {names['right']} {names['disp']}")
    train_list = os.path.join(root, "train.list")
    val_list = os.path.join(root, "val.list")
    with open(train_list, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(val_list, "w") as f:
        f.write("\n".join(lines[:n_val]) + "\n")
    return train_list, val_list


def file_path_phase(ops, record, work: str) -> dict:
    """Phase 15: StereoDataset -> train_transform -> DataLoader -> the
    prefetcher -> the trainer, on files written to ``work``/files (kept for
    phase 16); returns its launch counts."""
    from stereoformer_tpu_torch.data import native

    print(f"file path: SceneFlow-shaped PNG/PFM tree, {FILE_PAIRS} pairs of "
          f"540x960:", flush=True)
    out: dict = {}
    try:
        built = subprocess.run(["make", "-C", "native"], capture_output=True,
                               text=True, timeout=300)
        out["native_build"] = built.returncode
    except (OSError, subprocess.TimeoutExpired) as exc:
        out["native_build"] = str(exc)
    out["native"] = native.available()
    print(f"  native IO library: {'used' if out['native'] else 'not built'} "
          f"(make -C native: {out['native_build']})", flush=True)

    root = os.path.join(work, "files")
    os.makedirs(root)
    launches = train_on_files(ops, root, out)
    record["file_path"] = out
    return launches


def train_on_files(ops, root: str, out: dict) -> dict:
    from stereoformer_tpu_torch.train import DisparityTrainer

    train_list, val_list = write_sceneflow_tree(root, FILE_PAIRS,
                                                FILE_VAL_PAIRS)
    trainer = DisparityTrainer(
        lr=LR, dataset="SceneFlow", trainlist=train_list, vallist=val_list,
        datapath=root, batch_size=4, test_batch=4,
        crop_size=(TRAIN_H, TRAIN_W), train_iters=ITERS, eval_iters=ITERS,
        num_workers=4, device="cuda")
    trainer.initialize()
    loader = trainer.train_loader

    t0 = time.perf_counter()
    n = sum(b["img_left"].shape[0] for b in loader)
    out["decode_pairs_per_s"] = n / (time.perf_counter() - t0)
    print(f"  host pipeline (decode, crop, normalise, collate into page-locked "
          f"memory; 4 threads): {n} pairs at {out['decode_pairs_per_s']:.2f} "
          f"pairs/s, thread start-up included", flush=True)

    n_batches = check_prefetched_batches(loader, trainer.device)
    print(f"  {n_batches} batches through the prefetcher (DEPTH 2) equal to "
          f"their host batches bit for bit, read on the step's stream both "
          f"as soon as handed out and behind a long kernel", flush=True)

    reset_counts(ops)
    loss, epe, _ = trainer.train_one_epoch(0, 0, 0)
    val_epe = trainer.validate()
    launches = read_counts(ops)
    val_batches = len(trainer.val_loader)
    check_launches("file path", launches,
                   corr_band=n_batches + val_batches,
                   local_soft_argmin=ITERS * (n_batches + val_batches),
                   local_soft_argmin_bwd=ITERS * n_batches)
    print(f"  one epoch: loss {loss:.4f}, train EPE {epe:.4f}; validation at "
          f"576x960 over {len(trainer.val_set)} pairs ({val_batches} batches, "
          f"the last padded): EPE {val_epe:.4f}", flush=True)
    if not (np.isfinite(loss) and np.isfinite(val_epe)):
        raise SmokeFailure(f"file path: loss {loss}, val EPE {val_epe}")
    out.update(batches_equal=n_batches, loss=loss, val_epe=val_epe,
               launches=launches)
    return launches


def check_prefetched_batches(loader, device) -> int:
    """Every batch of one epoch through ``DevicePrefetcher`` against an
    independent host copy of it, bit for bit; returns the batch count.

    The page-locked originals are dropped as soon as they are handed over,
    and each card batch as soon as it is read, so their blocks go back to
    the host and device allocators while copies are still queued. The
    step's stream reads each batch twice, into a clone made as the batch
    is handed out (the stream must wait for its copy) and into one made
    behind a 4096-square float32 matmul, a few ms (the block must not go to a later copy before the
    stream is past it); the host reads the clones only at the end, so the
    host runs ahead of both streams the whole epoch."""
    from stereoformer_tpu_torch.data import DevicePrefetcher

    host = []

    def tapped():
        for b in loader:
            host.append({k: torch.as_tensor(v).clone() for k, v in b.items()})
            yield b

    busy = torch.randn(4096, 4096, device=device)
    early, late = [], []
    for dev in DevicePrefetcher(tapped(), device):
        early.append({k: v.clone() for k, v in dev.items()})
        torch.mm(busy, busy)
        late.append({k: v.clone() for k, v in dev.items()})
        del dev
    torch.cuda.synchronize()
    if len(early) != len(host) or len(early) <= 3 * DevicePrefetcher.DEPTH:
        raise SmokeFailure(f"prefetcher handed out {len(early)} of "
                           f"{len(host)} batches; want more than "
                           f"{3 * DevicePrefetcher.DEPTH}")
    for i, want in enumerate(host):
        for when, got in (("at hand-out", early[i]), ("behind a kernel",
                                                      late[i])):
            for k, v in want.items():
                if not torch.equal(got[k].cpu(), v):
                    raise SmokeFailure(f"batch {i} {k} differs on the card "
                                       f"({when})")
    return len(host)


def run_cli(main, argv: list) -> tuple:
    """``main(argv)`` of a CLI module; returns (its return value, what it
    printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    print("\n".join(f"    | {line}" for line in
                    buf.getvalue().splitlines()), flush=True)
    return out, buf.getvalue()


def entry_points_phase(ops, record, work: str) -> dict:
    """Phase 16: the evaluation entry points on the card, each through its
    main(argv), on phase 15's tree (``work``/files) and phase 14's
    model_best (``work``/model_best); returns the launch counts of each,
    counted from 0 just before it and read just after it."""
    from PIL import Image

    from stereoformer_tpu_torch import losses, metrics
    from stereoformer_tpu_torch.cli import (
        analysis,
        evaluate,
        gen_filelist,
        infer,
    )
    from stereoformer_tpu_torch.data import (
        DataLoader,
        StereoDataset,
        normalize,
        read_disp,
        read_img,
        to_unit,
        val_transform,
    )
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.ops import InputPadder, scale_disp
    from stereoformer_tpu_torch.train import TrainState, restore_params
    from stereoformer_tpu_torch.utils import AverageMeter

    root = os.path.join(work, "files")
    ckpt = os.path.join(work, "model_best")
    val_list = os.path.join(root, "val.list")
    torch.backends.cudnn.allow_tf32 = True
    print(f"entry points: cli.evaluate / infer / analysis / gen_filelist on "
          f"phase 15's tree ({FILE_VAL_PAIRS} val pairs, 540x960) and phase "
          f"14's model_best:", flush=True)
    out, launches = {}, {}

    def counted(path, main, argv, **want):
        reset_counts(ops)
        result = run_cli(main, argv)
        launches[path] = read_counts(ops)
        check_launches(path, launches[path], **want)
        return result

    val_batches = -(-FILE_VAL_PAIRS // 4)
    res, _ = counted(
        "cli_evaluate", evaluate.main,
        ["--net", "LowCNN_gru", "--ckpt", ckpt, "--dataset", "SceneFlow",
         "--vallist", val_list, "--datapath", root, "--test_batch", "4",
         "--workers", "4", "--device", "cuda"],
        corr_band=val_batches, local_soft_argmin=ITERS * val_batches)

    # the same evaluation by hand: the loader, the restored model, metrics
    model = get_model("LowCNN_gru", device="cuda")
    restore_params(ckpt, TrainState(step=0, model=model, opt_state=None))
    loader = DataLoader(
        StereoDataset(root, "", val_list, dataset_name="SceneFlow",
                      mode="val"), 4, shuffle=False, drop_last=False,
        num_workers=4, transform_with_rng=lambda s, rng: val_transform(s))
    meters = {k: AverageMeter() for k in ("EPE", "P1", "D1")}
    for batch in loader:
        left, right, gt = (torch.from_numpy(batch[k]).cuda() for k in
                           ("img_left", "img_right", "gt_disp"))
        with torch.inference_mode():
            pred = model(left, right, iters=ITERS)["disparities"][-1]
            pred = scale_disp(pred, (gt.shape[1], gt.shape[2]))
            m = {"EPE": losses.epe(pred, gt), "P1": metrics.p1_metric(pred, gt),
                 "D1": metrics.d1_metric(pred, gt)}
        if np.isfinite(float(m["EPE"])):
            for k, v in m.items():
                meters[k].update(float(v), left.shape[0])
    out["evaluate"] = res
    out["loop"] = loop = {k: v.avg for k, v in meters.items()}
    for k, v in loop.items():
        # the CLI prints 4 decimals
        want = round(v, 4)
        rel = abs(res[k] - want) / max(abs(want), 1e-12)
        print(f"  cli.evaluate {k} {res[k]} against the loop's {v:.6f}: "
              f"relative {rel:.2e} at 4 decimals (tolerance 1e-4) "
              f"{'ok' if rel <= 1e-4 else 'FAIL'}", flush=True)
        if not rel <= 1e-4:
            raise SmokeFailure(f"cli.evaluate {k} {res[k]} != loop {v}")
    if res["images"] != FILE_VAL_PAIRS or not res["s_per_image"] > 0:
        raise SmokeFailure(f"cli.evaluate: {res}")
    print(f"  cli.evaluate s_per_image {res['s_per_image']} "
          f"({FILE_VAL_PAIRS} pairs, batches of 4, 576x960, the first batch "
          f"included)", flush=True)

    # cli.infer on the first pair, and the same forward here
    lines = open(val_list).read().split()
    pair = [os.path.join(root, f) for f in lines[:3]]
    disp_out = os.path.join(work, "infer.pfm")
    err_out = os.path.join(work, "infer_error.png")
    disp, said = counted(
        "cli_infer", infer.main,
        ["--ckpt", ckpt, "--left", pair[0], "--right", pair[1],
         "--gt", pair[2], "--out", disp_out, "--error-out", err_out,
         "--device", "cuda"],
        corr_band=1, local_soft_argmin=ITERS)
    gt = read_disp(pair[2])
    sample = normalize(to_unit({"img_left": read_img(pair[0]),
                                "img_right": read_img(pair[1])}))
    li, ri = (torch.from_numpy(sample[k])[None].cuda()
              for k in ("img_left", "img_right"))
    padder = InputPadder(li.shape, divisor=8)
    with torch.inference_mode():
        mine = padder.unpad(model(*padder.pad(li, ri), iters=ITERS)[
            "disparities"][-1])[0, ..., 0].cpu().numpy()
    epe = float(np.abs(mine - gt)[gt > 0].mean())
    printed = float(said.rsplit("(EPE ", 1)[1].split(")")[0])
    err_img = np.asarray(Image.open(err_out))
    ok = (disp.shape == gt.shape == (540, 960)
          and err_img.shape == (540, 960, 3)
          and abs(printed - epe) <= 1e-6 + 1e-4 * abs(epe))
    print(f"  cli.infer: disparity {disp.shape}, error image "
          f"{err_img.shape}, printed EPE {printed} against {epe:.6f} from "
          f"the same forward here {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure("cli.infer: shapes or EPE disagree")
    out["infer"] = {"epe": printed, "phase_epe": epe}

    npz = os.path.join(work, "analysis.npz")
    counted("cli_analysis", analysis.main,
            ["--ckpt", ckpt, "--left", pair[0], "--right", pair[1],
             "--disp", pair[2], "--out", npz, "--device", "cuda"],
            corr_band=1, local_soft_argmin=ITERS)
    with np.load(npz) as z:
        shapes = {k: z[k].shape for k in z.files}
    want = {"disp_low": (67, 120), "disp_final": (536, 960),
            "gt": (536, 960)}
    print(f"  cli.analysis .npz: {shapes} "
          f"{'ok' if shapes == want else 'FAIL'}", flush=True)
    if shapes != want:
        raise SmokeFailure(f"cli.analysis .npz {shapes}, expected {want}")

    listed = os.path.join(work, "gen.list")
    reset_counts(ops)
    run_cli(gen_filelist.main,
            ["--root", root, "--left-dir", SCENEFLOW_DIRS["left"],
             "--right-dir", SCENEFLOW_DIRS["right"],
             "--disp-dir", SCENEFLOW_DIRS["disp"], "--out", listed])
    same = open(listed, "rb").read() == open(
        os.path.join(root, "train.list"), "rb").read()
    print(f"  cli.gen_filelist: the tree's own train list "
          f"{'byte for byte' if same else 'NOT reproduced'}", flush=True)
    if not same:
        raise SmokeFailure("cli.gen_filelist: list differs")

    res, said = counted(
        "cli_evaluate_cross_attention", evaluate.main,
        ["--net", "CrossAttentionStereo", "--dataset", "dummy",
         "--test_batch", "4", "--workers", "4", "--device", "cuda"],
        local_soft_argmin=ITERS * 2)
    line = json.loads(said.strip().splitlines()[-1])
    if line != res or res["images"] != 8 or not np.isfinite(res["EPE"]):
        raise SmokeFailure(f"cli.evaluate CrossAttentionStereo: {said}")
    out["evaluate_cross_attention"] = res
    out["launches"] = launches
    record["entry_points"] = out
    return launches


def bf16_close(label: str, got: torch.Tensor, want: torch.Tensor,
               rtol: float = 2.0 ** -20) -> float:
    """Phases 17 and 18: every output of the bf16 ``got`` within one bf16
    ulp of ``want`` (bf16, or float64 sums rounded to bf16 once), or near
    0, where the sums cancel, within the float32 sums' own error, ``rtol``
    of the largest |want|. Returns the largest absolute error."""
    torch.cuda.synchronize()
    ref = want.to(torch.bfloat16)
    if (got.shape != ref.shape or got.dtype != ref.dtype
            or want.dtype not in (torch.bfloat16, torch.float64)):
        raise SmokeFailure(f"{label}: {got.dtype} {tuple(got.shape)} != "
                           f"{want.dtype} {tuple(want.shape)}")
    g, w = got.double(), ref.double()
    big = torch.maximum(g.abs(), w.abs()).clamp(min=1e-30)
    ulp = 2.0 ** -7 * torch.exp2(torch.floor(torch.log2(big)))
    tol = ulp.clamp(min=rtol * want.abs().max().item())
    diff = (g - w).abs()
    share = (diff / tol).max().item()
    ok = bool(torch.isfinite(g).all()) and bool((diff <= tol).all())
    err = diff.max().item()
    print(f"  {label}: max_abs_err {err:.3e}, {(diff > 0).float().mean():.1e} "
          f"of the outputs differ, the worst at {share:.2f} of its "
          f"tolerance (one bf16 ulp, or {rtol:.3g} of the largest output) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(f"{label}: beyond one bf16 ulp")
    return err


# the bf16 fused conv's edge shapes (B, H, W, C, Co): H and W no multiple
# of its 4 x 32 tile; C = 72, a 32-channel chunk with 24 zero-filled
# channels; Co 64 (one 64-channel block a tile) and 96 (two of 48) from
# either C
EDGE_BF16_CONVS = [(1, 37, 53, 96, 96), (2, 19, 40, 72, 64),
                   (1, 17, 45, 72, 96), (1, 9, 33, 64, 96),
                   (2, 35, 70, 96, 64)]


# corr_band_bf16's edge shapes ((B, H, W, C), D): W below D; ragged W at
# D = 50; C = 72 and 8 (the last k16 step half zero-filled); D = 1024 and
# 256 in spans of 128, D = 200 in two of 104; W one pixel past a tile of
# 64 and of 128 pixels
EDGE_BF16_CORR = [((1, 3, 10, 40), 24), ((1, 2, 97, 64), 50),
                  ((2, 3, 57, 72), 24), ((1, 2, 33, 8), 40),
                  ((1, 2, 70, 32), 1024),
                  ((1, 2, 300, 16), 256), ((2, 2, 81, 16), 200),
                  ((1, 2, 65, 256), 24), ((1, 2, 129, 256), 96)]


def check_bf16_kernels(ops, rng) -> dict:
    """Phase 17: the bf16 forms against their plain bf16 versions."""
    print("bf16 kernels vs plain (TF32 off):", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    err = {"corr_band_bf16": 0.0, "conv2d_fused_bf16": 0.0}
    for shape, d in [((B, H // 8, W // 8, 256), 24),
                     ((4, TRAIN_H // 8, TRAIN_W // 8, 256), 24),
                     ((B, H // 8, W // 8, 256), 96)] + EDGE_BF16_CORR:
        left = randn(rng, *shape).bfloat16()
        right = randn(rng, *shape).bfloat16()
        err["corr_band_bf16"] = max(err["corr_band_bf16"], bf16_close(
            f"corr_band_bf16 {shape} D={d}",
            ops.correlation_volume(left, right, d),
            ops.correlation_volume_plain(left, right, d)))
    # the moments: within 1e-5 relative (of each and of the largest),
    # beyond what the outputs that round to the neighbouring bf16 move them
    moment_rtol = 1e-5
    shapes = [(where, (B_, H_, W_, C, C))
              for where, (B_, H_, W_, C) in RAFT_CONVS.items()]
    shapes += [("edge", shape) for shape in EDGE_BF16_CONVS]
    for where, shape in shapes:
        x, w, b, s, t, r = conv_inputs(rng, *shape)
        x, w, b, r = (a.bfloat16() for a in (x, w, b, r))
        for variant, (call, kw) in conv_calls(ops, x, w, b, s, t,
                                              r).items():
            got, want = call(), ops.conv3x3_plain(x, w, b, **kw)
            if not kw.get("with_stats"):
                got, want = (got,), (want,)
            label = f"conv2d_fused_bf16 {variant} {where} {list(shape)}"
            err["conv2d_fused_bf16"] = max(err["conv2d_fused_bf16"],
                                           bf16_close(label, got[0], want[0]))
            yg, yw = got[0].double(), want[0].double()
            slack = ((yg - yw).abs().sum((1, 2)),
                     (yg ** 2 - yw ** 2).abs().sum((1, 2)))
            for part, g, m, sl in zip(("S1", "S2"), got[1:], want[1:], slack):
                m = m.double()
                tol = moment_rtol * (m.abs() + m.abs().max()) + sl
                bad = (g.double() - m).abs() > tol
                print(f"    {part}: max rel err "
                      f"{((g.double() - m).abs() / m.abs().max()).max():.2e} "
                      f"{'FAIL' if bad.any() else 'ok'}", flush=True)
                if bad.any():
                    raise SmokeFailure(f"{label} {part} moments disagree")
            del got, want, yg, yw
        del x, w, b, s, t, r
    torch.backends.cudnn.allow_tf32 = True
    return err


# the registry names' earlier float32 eval phases (record key) at the same
# protocol; a name without one is timed in float32 here
F32_EVAL_KEYS = {"LowCNN_gru": "eval", "LowCNN_dynamic": "dynamic_eval",
                 "LowCNN": "LowCNN_eval", "LowCNN_simple": "LowCNN_simple_eval",
                 "LowCNN_ada": "LowCNN_ada_eval",
                 "LowCNN_gru2": "LowCNN_gru2_eval",
                 "CrossAttentionStereo": "CrossAttentionStereo_eval",
                 "RAFT_Stereo B=2": "raft_eval_b2",
                 "RAFT_Stereo B=8": "raft_eval_b8"}


def bf16_eval_phase(ops, record) -> dict:
    """Phase 17: every registry name's eval in bf16 and float32 at
    bench.py's protocol; returns the bf16 launch counts per path."""
    from stereoformer_tpu_torch.models import get_model

    print(f"bf16 serving: every registry name's eval at {H}x{W}, "
          f"iters={ITERS}, bf16 and float32:", flush=True)
    # bench.py:77-78 (LowCNN) and :234-237 (RAFT, raw 0..255 images)
    brng = np.random.RandomState(0)
    left = torch.from_numpy(brng.randn(B, H, W, 3).astype(np.float32)).cuda()
    right = torch.from_numpy(brng.randn(B, H, W, 3).astype(np.float32)).cuda()
    raw = [torch.from_numpy(brng.uniform(0, 255, (B, H, W, 3)).astype(
        np.float32)).cuda() for _ in range(2)]
    cases = [(name, B, {}) for name in LOWCNN] + [
        (f"RAFT_Stereo B={b}", b, {"input_norm": "raw"})
        for b in RAFT_BATCHES]
    launches, rec = {}, {}
    for label, batch, kw in cases:
        name = label.split()[0]
        raft = name == "RAFT_Stereo"
        li, ri = (raw[0][:batch], raw[1][:batch]) if raft else (left, right)
        run_kw = {"test_mode": True} if raft else {}
        row, disp = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            model = get_model(name, device="cuda", dtype=dtype, **kw)

            def forward(model=model):
                with torch.inference_mode():
                    return model(li, ri, iters=ITERS, **run_kw)

            torch.cuda.reset_peak_memory_stats()
            reset_counts(ops)
            out = forward()
            counts = read_counts(ops)
            d = out["disparities"][-1]
            if d.dtype != torch.float32 or not torch.isfinite(d).all():
                raise SmokeFailure(f"{label} {dtype}: disparities "
                                   f"{d.dtype}, finite="
                                   f"{bool(torch.isfinite(d).all())}")
            disp[dtype] = d
            key = "bf16" if dtype == torch.bfloat16 else "f32"
            row[f"{key}_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del out
            if dtype == torch.bfloat16:
                want = ({"conv2d_fused_bf16": 14} if raft else {
                    ("corr_band_bf16" if k == "corr_band" else k): v
                    for k, v in LOWCNN[name][1].items()})
                check_launches(f"{label} bf16 eval", counts, **want)
                launches[f"bf16_{label.replace(' ', '_')}_eval"] = counts
                ms = time_ms(forward, reps=2 if raft else 10, warmup=1)
                bf16_forward = forward
                row["bf16"] = {"ms_per_batch": ms,
                               "pairs_per_s": batch / ms * 1e3}
            elif F32_EVAL_KEYS.get(label) in record:
                prior = record[F32_EVAL_KEYS[label]]
                row["f32_from"] = F32_EVAL_KEYS[label]
                row["tf32_convs"] = prior["tf32_convs"]
                row["strict_f32"] = prior["strict_f32"]
            else:
                for tf32 in (True, False):
                    torch.backends.cudnn.allow_tf32 = tf32
                    ms = time_ms(forward, reps=2 if raft else 10, warmup=1)
                    row["tf32_convs" if tf32 else "strict_f32"] = {
                        "ms_per_batch": ms, "pairs_per_s": batch / ms * 1e3}
                torch.backends.cudnn.allow_tf32 = True
        gap = (disp[torch.bfloat16].double()
               - disp[torch.float32].double()).abs().mean().item()
        row["bf16_vs_f32_mean_abs_px"] = gap
        if label in ("LowCNN_gru", "RAFT_Stereo B=2"):
            # where a bf16 forward's device time goes
            row["bf16_profile"] = profile(bf16_forward, f"{label} bf16 "
                                          f"forward")
        rec[label] = row
        print(f"  {label}: bf16 {row['bf16']['ms_per_batch']:.2f} ms/batch "
              f"({row['bf16']['pairs_per_s']:.2f} pairs/s), peak "
              f"{row['bf16_peak_mem_gb']:.2f} GB; float32 "
              f"{row['tf32_convs']['ms_per_batch']:.2f} ms/batch TF32 convs, "
              f"{row['strict_f32']['ms_per_batch']:.2f} strict"
              f"{' (phase ' + row['f32_from'] + ')' if 'f32_from' in row else ''}"
              f", peak {row['f32_peak_mem_gb']:.2f} GB; bf16 launches "
              f"{ {k: v for k, v in counts.items() if v} }; disparities "
              f"float32 and finite; bf16 vs float32 mean abs {gap:.4f} px "
              f"(bench.py's agreement {BF16_AGREEMENT_PX} px; random "
              f"weights)", flush=True)
        del disp, model, bf16_forward
    record["bf16_eval"] = rec
    return launches


def bf16_kernel_rows(ops, rng, err, launches, record) -> list:
    """Phase 17: the bf16 forms' device time by graph replay at the main
    path's shapes, beside their bounds (bytes at the HBM rate or
    operations at the bf16 tensor-core rate, the card's dense bf16 rate
    whatever the design), the plain versions and the library."""
    import torch.nn.functional as F

    from stereoformer_tpu_torch import kernels
    from stereoformer_tpu_torch.ops.cost_volume import corr_bf16_plan
    from stereoformer_tpu_torch.ops.fused_conv import fused_blocks

    rows, times = [], {"corr_band_bf16": {}, "conv2d_fused_bf16": {}}
    C = 256
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ptxas = kernels.ptxas_usage("corr_band_bf16")
    print(f"  corr_band_bf16 registers and spills (ptxas): "
          f"{ {k: v for k, v in ptxas.items() if 'bf16' in k} }", flush=True)
    for shape, d in (((B, H // 8, W // 8, C), 24),
                     ((4, TRAIN_H // 8, TRAIN_W // 8, C), 24),
                     ((B, H // 8, W // 8, C), 96)):
        left = randn(rng, *shape).bfloat16()
        right = randn(rng, *shape).bfloat16()
        plan = corr_bf16_plan(*shape, d, sms)
        npix = int(np.prod(shape[:3]))
        nbytes = (2 * npix * C + npix * d) * 2
        band = shape[0] * shape[1] * (d * shape[2] - d * (d - 1) // 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # bf16 products: the card's bf16 rate, whatever the design
        t_ops = 2 * C * band / BF16_FLOPS_PER_S * 1e3
        t = {"ms": graph_ms(lambda: ops.correlation_volume(left, right, d),
                            50),
             "plain_ms": graph_ms(
                 lambda: ops.correlation_volume_plain(left, right, d), 5),
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "mb": nbytes / 1e6, "library_ms": None,
             "plan": {k: plan[k] for k in ("warps", "nt", "tasks", "per_sm",
                                           "blocks")}}
        times["corr_band_bf16"][f"{list(shape)} D={d}"] = t
        print(f"  corr_band_bf16 {shape} D={d}: {t['ms'] * 1e3:.1f} us on the "
              f"device (bound {t['bound_ms'] * 1e3:.2f} us by "
              f"{t['bound_by']}, {t['mb']:.2f} MB, "
              f"{100 * t['bound_ms'] / t['ms']:.0f}% of it), plain "
              f"{t['plain_ms'] * 1e3:.1f} us; no library call; "
              f"{plan['blocks']} blocks of {plan['warps']} warps, "
              f"{plan['tasks']} tasks", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    for where, (B_, H_, W_, C_) in RAFT_CONVS.items():
        x, w, b, s, t_, r = conv_inputs(rng, B_, H_, W_, C_, C_)
        x, w, b, r = (a.bfloat16() for a in (x, w, b, r))
        variant = "prologue+stats" if where.startswith("fnet") else "prologue"
        kern, kw = conv_calls(ops, x, w, b, s, t_, r)[variant]
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        nbytes = (2 * B_ * H_ * W_ * C_ + 9 * C_ * C_ + C_) * 2
        nops = 2 * 9 * C_ * C_ * B_ * H_ * W_
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / BF16_FLOPS_PER_S * 1e3
        row = {"variant": variant, "shape": [B_, H_, W_, C_, C_],
               "gflop": nops / 1e9, "mb": nbytes / 1e6,
               "ms": graph_ms(kern, 10),
               "plain_ms": graph_ms(
                   lambda: ops.conv3x3_plain(x, w, b, **kw), 3),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "blocks": fused_blocks(B_, H_, W_, C_, torch.bfloat16),
               "library_ms": graph_ms(
                   lambda: F.conv2d(xc, wc, b, padding=1), 10)}
        row["kernel_vs_library"] = row["ms"] / row["library_ms"]
        times["conv2d_fused_bf16"][where] = row
        print(f"  conv2d_fused_bf16 {variant} {where} {row['shape']}: "
              f"{row['ms']:.4f} ms on the device "
              f"({nops / row['ms'] / 1e9:.1f} TFLOP/s, {row['blocks']} "
              f"blocks); bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']} ({100 * row['bound_ms'] / row['ms']:.0f}% "
              f"of it); plain {row['plain_ms']:.4f} ms; cuDNN F.conv2d+bias "
              f"bf16 {row['library_ms']:.4f} ms; kernel/cuDNN "
              f"{row['kernel_vs_library']:.2f} ("
              f"{'beats' if row['kernel_vs_library'] < 1 else 'loses to'} "
              f"cuDNN)", flush=True)
        del x, w, b, s, t_, r, xc, wc
    torch.backends.cudnn.allow_tf32 = True
    record["kernel_times"].update(times)
    for name, main_key, path in (
            ("corr_band_bf16", f"{[B, H // 8, W // 8, C]} D=24",
             "bf16_LowCNN_gru_eval"),
            ("conv2d_fused_bf16", "fnet layer1", "bf16_RAFT_Stereo_B=2_eval")):
        main = times[name][main_key]
        route, source, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[path][name],
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "max_abs_err": err[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main.get("shape", main_key),
            "ptxas": kernels.ptxas_usage(name)})
    return rows


def bf16_parity_vs_cpu() -> dict:
    """Phase 17: the card's bf16 against the port's bf16 on the CPU, TF32
    off, moderate weights: LowCNN_gru at 64x256 and RAFT_Stereo at 64x128,
    12 iterations. A bf16 forward moves by its own rounding's size under any
    change of summation order, so the gate is the CPU port's own
    bf16-against-float32 gap on the same input."""
    from stereoformer_tpu_torch.models import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("bf16: the card against the CPU port, TF32 off:", flush=True)
    out = {}
    for name, h, w, seed in (("LowCNN_gru", 64, 256, 2),
                             ("RAFT_Stereo", 64, 128, 5)):
        sd = moderate_weights(name)
        srng = np.random.default_rng(seed)
        li, ri = (torch.from_numpy(srng.standard_normal((2, h, w, 3),
                                                        dtype=np.float32))
                  for _ in range(2))
        disp = {}
        runs = [("cpu", torch.bfloat16), ("cuda", torch.bfloat16)]
        if (name, seed) in CPU_F32_LAST:   # phase 13 ran it
            disp[("cpu", torch.float32)] = CPU_F32_LAST[(name, seed)].double()
        else:
            runs.append(("cpu", torch.float32))
        for where, dtype in runs:
            m = get_model(name, device=where, dtype=dtype)
            m.load_state_dict(sd)
            with torch.inference_mode():
                o = m(li.to(where), ri.to(where), iters=ITERS)
            disp[(where, dtype)] = o["disparities"][-1].cpu().double()
        cpu16 = disp[("cpu", torch.bfloat16)]
        gap = (cpu16 - disp[("cpu", torch.float32)]).abs().mean().item()
        card = (disp[("cuda", torch.bfloat16)] - cpu16).abs().mean().item()
        ok = card <= gap
        print(f"  {name}: card bf16 vs CPU bf16 mean abs {card:.4f} px, the "
              f"CPU port's bf16 vs float32 {gap:.4f} px "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SmokeFailure(f"{name}: the card's bf16 is {card} px from "
                               f"the CPU port's, above its gap {gap}")
        out[name] = {"card_vs_cpu_bf16_px": card, "cpu_bf16_vs_f32_px": gap}
    torch.backends.cudnn.allow_tf32 = True
    return out


# phase 18: the bf16 train steps, at bench.py's train rows' widths (its
# LowCNN_gru rows at 320x640, B=4 and B=8, and RAFT at 320x720, B=4; every
# other registry name at 320x640, B=4): name -> (the trainer's loss, batch
# sizes)
BF16_TRAIN = {
    "LowCNN_gru": ("sequence", TRAIN_BATCHES),
    "LowCNN_gru2": ("sequence", (4,)), "LowCNN": ("single", (4,)),
    "LowCNN_simple": ("single", (4,)), "LowCNN_ada": ("equal", (4,)),
    "LowCNN_dynamic": ("equal", (4,)),
    "LowCNN_dynamic_supervised": ("range_supervised", (4,)),
    "CrossAttentionStereo": ("sequence", (4,)),
}
# conv2d_dw_bf16's and the bf16 dx conv's edge shapes (B, H, W, C): H and W
# off the fused conv's 8 x 32 tiles, C 64 and 96; for the dw kernel's walk
# of 16-column strips down runs of rows, W off the strip (53, 33, 50, 21)
# and under it (5, 7), images of 1 and 2 rows (the ring's first and last
# rows at once), and runs that end inside an image (3 x 97 rows of 4
# strips, 2 x 150 of 3, over the grid's 132 or 44 splits)
EDGE_BF16_TRAIN = [(1, 37, 53, 96), (2, 19, 40, 64), (1, 9, 33, 96),
                   (2, 3, 5, 64), (1, 1, 40, 64), (1, 2, 21, 96),
                   (1, 11, 7, 96), (3, 97, 50, 64), (2, 150, 48, 96)]
# the bf16 dw against float64 sums: where they cancel to near 0, the float32
# tile sums' own error, relative to the largest |dw| (the float32 form's
# bound, phase 3)
DW_BF16_RTOL = 2e-5


def check_bf16_train_kernels(ops, rng) -> dict:
    """Phase 18: conv2d_dw_bf16 and the bf16 dx conv against their plain
    versions at RAFT's four train sites and at edge shapes, and bit-equal to
    themselves on a second call."""
    from stereoformer_tpu_torch.ops.fused_conv import _dx_conv

    print("bf16 training kernels vs plain (TF32 off):", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    err = {"conv2d_dw_bf16": 0.0, "conv2d_fused_bf16_dx": 0.0}
    shapes = [(where, v) for where, v in RAFT_TRAIN_CONVS.items()]
    shapes += [("edge", v) for v in EDGE_BF16_TRAIN]
    for where, shape in shapes:
        C = shape[3]
        x = randn(rng, *shape).bfloat16()
        g = randn(rng, *shape).bfloat16()
        got = ops.conv2d_dw(x, g)
        err["conv2d_dw_bf16"] = max(err["conv2d_dw_bf16"], bf16_close(
            f"conv2d_dw_bf16 {where} {list(shape)}", got,
            ops.conv2d_dw_plain(x.double(), g.double()), DW_BF16_RTOL))
        if not torch.equal(ops.conv2d_dw(x, g), got):
            raise SmokeFailure(f"conv2d_dw_bf16 {shape}: two calls differ")
        w = (randn(rng, 3, 3, C, C) / np.sqrt(9 * C)).bfloat16()
        w_rot = w.flip((0, 1)).transpose(2, 3).contiguous()
        zero = torch.zeros(C, device="cuda", dtype=torch.bfloat16)
        got = _dx_conv(g, w_rot, zero)
        err["conv2d_fused_bf16_dx"] = max(
            err["conv2d_fused_bf16_dx"],
            bf16_close(f"conv2d_fused_bf16 as dx {where} {list(shape)}", got,
                       ops.conv3x3_plain(g, w_rot, zero)))
        if not torch.equal(_dx_conv(g, w_rot, zero), got):
            raise SmokeFailure(f"bf16 dx {shape}: two calls differ")
        del x, g, got, w, w_rot
    print("  conv2d_dw_bf16 and the bf16 dx conv: two calls on the same "
          "inputs gave the same bits at every shape", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    return err


# phase 18: steps of each dtype timed in turns, one bf16 step then one
# float32 step, this many pairs after a warm-up pair
BF16_TIMED_PAIRS = 10


def paired_ms(a, b, pairs: int) -> tuple:
    """``a`` and ``b`` called in turns, each call timed by CUDA events:
    (a's times, b's times) in ms, one of each per pair. Taken in turns so
    that a slow or fast stretch of the host falls on both."""
    a(), b()
    times = ([], [])
    for _ in range(pairs):
        for fn, out in zip((a, b), times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return times


def bf16_train_case(ops, record, label: str, build, batch: int,
                    want: dict, profile_kernels=None) -> dict:
    """Phase 18: one bf16 train case. ``build(dtype)`` returns (model, step,
    state, data). The bf16 step: launch counts (``want``), finite
    gradients and float32 parameters, a falling loss over 5 steps on one
    batch, peak memory; then the float32 step (TF32 convs) built beside it,
    its peak memory, and the two timed in turns (``paired_ms``): the median
    ms/step of each, the median of the per-pair ratio bf16/float32 and its
    range. Returns the launch counts of one bf16 step."""
    model, step, state, data = build(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    state, m = step(state, data)
    counts = read_counts(ops)
    check_launches(f"{label} bf16 train step", counts, **want)
    finite = torch.stack([torch.isfinite(p.grad).all()
                          for p in model.parameters()]).all().item()
    f32 = all(p.dtype == torch.float32 for p in model.parameters())
    if not (finite and f32):
        raise SmokeFailure(f"{label} bf16 step: gradients finite={finite}, "
                           f"parameters float32={f32}")
    curve = [float(m["loss"])]
    for _ in range(4):
        state, m = step(state, data)
        curve.append(float(m["loss"]))
    if not np.all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise SmokeFailure(f"{label} bf16 loss not finite or not falling: "
                           f"{curve}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    def one_step():
        step(state, data)

    row = {"loss_curve": curve, "launches": counts}
    if profile_kernels is not None:
        row["bf16_profile"] = profile(one_step, f"{label} bf16 train step",
                                      kernels=profile_kernels)
    # the float32 step's peak, less what the bf16 side holds meanwhile
    held = torch.cuda.memory_allocated()
    model32, step32, state32, data32 = build(None)
    torch.cuda.reset_peak_memory_stats()
    state32, _ = step32(state32, data32)
    peak32 = (torch.cuda.max_memory_allocated() - held) / 1e9
    t16, t32 = paired_ms(one_step, lambda: step32(state32, data32),
                         BF16_TIMED_PAIRS)
    del model, step, state, data, one_step, model32, step32, state32, data32
    torch.cuda.empty_cache()
    ratios = [a / b for a, b in zip(t16, t32)]
    ms, ms32 = float(np.median(t16)), float(np.median(t32))
    row.update({
        "bf16": {"ms_per_step": ms, "pairs_per_s": batch / ms * 1e3,
                 "peak_mem_gb": peak, "ms_all": t16},
        "f32": {"ms_per_step": ms32, "pairs_per_s": batch / ms32 * 1e3,
                "peak_mem_gb": peak32, "ms_all": t32},
        "bf16_over_f32": float(np.median(ratios)),
        "bf16_over_f32_range": [min(ratios), max(ratios)]})
    print(f"  {label}: bf16 {ms:.2f} ms/step ({min(t16):.2f}-"
          f"{max(t16):.2f}; {batch / ms * 1e3:.2f} pairs/s), peak "
          f"{peak:.2f} GB; float32 (TF32 convs) {ms32:.2f} ms/step "
          f"({min(t32):.2f}-{max(t32):.2f}), peak {peak32:.2f} GB; bf16/f32 "
          f"{row['bf16_over_f32']:.2f} (median of {BF16_TIMED_PAIRS} pairs "
          f"taken in turns, {min(ratios):.2f}-{max(ratios):.2f}); loss over "
          f"5 steps {', '.join(f'{x:.3f}' for x in curve)}; launches "
          f"{ {k: v for k, v in counts.items() if v} }; gradients finite, "
          f"parameters float32", flush=True)
    record.setdefault("bf16_train", {})[label] = row
    return counts


def bf16_train_phase(ops, record) -> dict:
    """Phase 18: every registry name's bf16 train step at bench.py's widths;
    returns the launch counts per path."""
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.train import (
        Amsgrad,
        TrainState,
        make_train_step,
    )

    print(f"bf16 training: every registry name's train step, iters={ITERS}, "
          f"AMSGrad, bf16 beside float32:", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    launches = {}
    for name, (loss, batches) in BF16_TRAIN.items():
        for batch in batches:
            def build(dtype, name=name, loss=loss, batch=batch):
                model = get_model(name, device="cuda", dtype=dtype)
                tx = Amsgrad(LR)
                return (model, make_train_step(tx, loss, iters=ITERS),
                        TrainState.create(model, tx),
                        train_batch(3, batch, TRAIN_H, TRAIN_W))

            want = {("corr_band_bf16" if k == "corr_band" else k): v
                    for k, v in train_launches(name).items()}
            label = f"{name} {TRAIN_H}x{TRAIN_W} B={batch}"
            launches[f"bf16_{name}_train_b{batch}"] = bf16_train_case(
                ops, record, label, build, batch, want,
                ("corr_band_bf16_kernel", "local_soft_argmin")
                if (name, batch) == ("LowCNN_gru", 4) else None)

    def build_raft(dtype):
        model, _, state, step, data = raft_train_setup(dtype)
        return model, step, state, data

    launches["bf16_raft_train_step"] = bf16_train_case(
        ops, record,
        f"RAFT_Stereo {RAFT_TRAIN_H}x{RAFT_TRAIN_W} B={RAFT_TRAIN_B}",
        build_raft, RAFT_TRAIN_B,
        {"conv2d_fused_bf16": 28, "conv2d_fused_bf16_dx": 14,
         "conv2d_dw_bf16": 14},
        ("conv3x3_bf16_kernel", "dw_bf16_kernel", "dw_reduce_bf16_kernel",
         "moments_kernel"))
    return launches


# conv2d_dw's calls in one RAFT train step, by site
RAFT_TRAIN_DW_CALLS = {"fnet layer1": 4, "cnet layer1": 4, "fnet layer2": 3,
                       "cnet layer2": 3}


def bf16_train_kernel_rows(ops, rng, err, launches, record) -> list:
    """Phase 18: conv2d_dw_bf16 and the bf16 dx conv at RAFT's four train
    sites by graph replay, beside their bound (bytes at the HBM rate or
    operations at the bf16 tensor-core rate) and the share of it they
    reach, their plain versions, cuDNN's bf16 conv2d_weight and
    conv2d_input, and the float32 forms (conv2d_dw, conv2d_fused as dx) in
    the same call; conv2d_dw_bf16's 14 launches of one RAFT bf16 step by
    graph replay and by the phase's profile. Returns conv2d_dw_bf16's row
    and adds the dx conv's times to conv2d_fused_bf16's."""
    from torch.nn.grad import conv2d_input, conv2d_weight

    from stereoformer_tpu_torch import kernels
    from stereoformer_tpu_torch.ops.fused_conv import _dx_conv, fused_blocks

    torch.backends.cudnn.allow_tf32 = False
    times = {"conv2d_dw_bf16": {}, "conv2d_fused_bf16_dx": {}}
    for where, (B_, H_, W_, C) in RAFT_TRAIN_CONVS.items():
        x32, g32 = randn(rng, B_, H_, W_, C), randn(rng, B_, H_, W_, C)
        w32 = randn(rng, 3, 3, C, C) / np.sqrt(9 * C)
        x, g, w = x32.bfloat16(), g32.bfloat16(), w32.bfloat16()
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        w_rot = w.flip((0, 1)).transpose(2, 3).contiguous()
        w_rot32 = w32.flip((0, 1)).transpose(2, 3).contiguous()
        zero = torch.zeros(C, device="cuda", dtype=torch.bfloat16)
        zero32 = torch.zeros(C, device="cuda")
        nops = 2 * 9 * C * C * B_ * H_ * W_
        t_ops = nops / BF16_FLOPS_PER_S * 1e3
        for name, nbytes, kern, plain, lib, f32 in (
                ("conv2d_dw_bf16", (2 * B_ * H_ * W_ * C + 9 * C * C) * 2,
                 lambda: ops.conv2d_dw(x, g),
                 lambda: ops.conv2d_dw_plain(x, g),
                 lambda: conv2d_weight(xc, (C, C, 3, 3), gc, padding=1),
                 lambda: ops.conv2d_dw(x32, g32)),
                ("conv2d_fused_bf16_dx",
                 (2 * B_ * H_ * W_ * C + 9 * C * C) * 2,
                 lambda: _dx_conv(g, w_rot, zero),
                 lambda: ops.conv3x3_plain(g, w_rot, zero),
                 lambda: conv2d_input((B_, C, H_, W_), wc, gc, padding=1),
                 lambda: _dx_conv(g32, w_rot32, zero32))):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            row = {"shape": [B_, H_, W_, C, C], "gflop": nops / 1e9,
                   "mb": nbytes / 1e6, "ms": graph_ms(kern, 10),
                   "plain_ms": graph_ms(plain, 3),
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": graph_ms(lib, 10),
                   "f32_form_ms": graph_ms(f32, 10)}
            if name == "conv2d_fused_bf16_dx":
                row["blocks"] = fused_blocks(B_, H_, W_, C, torch.bfloat16)
            row["kernel_vs_library"] = row["ms"] / row["library_ms"]
            row["bound_share"] = row["bound_ms"] / row["ms"]
            times[name][where] = row
            print(f"  {name} {where} {row['shape']}: {row['ms']:.4f} ms on "
                  f"the device ({nops / row['ms'] / 1e9:.1f} TFLOP/s); "
                  f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
                  f"({100 * row['bound_share']:.0f}% of it); plain "
                  f"{row['plain_ms']:.4f} ms; cuDNN bf16 "
                  f"{'conv2d_weight' if 'dw' in name else 'conv2d_input'} "
                  f"{row['library_ms']:.4f} ms (kernel/cuDNN "
                  f"{row['kernel_vs_library']:.2f}); the float32 form "
                  f"{row['f32_form_ms']:.4f} ms", flush=True)
        del x32, g32, w32, x, g, w, xc, gc, wc, w_rot, w_rot32
    torch.backends.cudnn.allow_tf32 = True
    record["kernel_times"].update(times)
    usage = kernels.ptxas_usage("conv2d_dw_bf16")
    print("  ptxas: " + ", ".join(
        f"{e} {u.get('registers')} registers, {u.get('spill_stores')} B "
        f"spilled" for e, u in usage.items() if "bf16" in e), flush=True)
    # the 14 launches of one RAFT bf16 step: graph replay by site, and the
    # phase's profile of the step (dw_bf16_kernel and its reduction)
    dw = times["conv2d_dw_bf16"]
    step = {"graph_ms": sum(n * dw[w]["ms"]
                            for w, n in RAFT_TRAIN_DW_CALLS.items()),
            "library_ms": sum(n * dw[w]["library_ms"]
                              for w, n in RAFT_TRAIN_DW_CALLS.items()),
            "bound_ms": sum(n * dw[w]["bound_ms"]
                            for w, n in RAFT_TRAIN_DW_CALLS.items())}
    prof = record["bf16_train"][
        f"RAFT_Stereo {RAFT_TRAIN_H}x{RAFT_TRAIN_W} B={RAFT_TRAIN_B}"][
        "bf16_profile"].get("kernels_ms")
    step["profile_ms"] = ("not measured" if prof is None else
                          prof["dw_bf16_kernel"]
                          + prof["dw_reduce_bf16_kernel"])
    print(f"  conv2d_dw_bf16's 14 launches in one RAFT bf16 step: "
          f"{step['graph_ms']:.3f} ms by graph replay (cuDNN bf16 "
          f"{step['library_ms']:.3f}, bound {step['bound_ms']:.3f}); by "
          f"the step's profile " + (f"{step['profile_ms']:.3f} ms"
                                    if prof is not None else "not measured"),
          flush=True)
    main = dw["fnet layer1"]
    route, source, replaces = KERNELS["conv2d_dw_bf16"]
    return [{
        "name": "conv2d_dw_bf16", "route": route, "source": source,
        "replaces": replaces,
        "launches": launches["bf16_raft_train_step"]["conv2d_dw_bf16"],
        "launches_by_path": {p: c["conv2d_dw_bf16"]
                             for p, c in launches.items()},
        "max_abs_err": err["conv2d_dw_bf16"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "bound_share": main["bound_share"], "raft_step": step, "f32_form_ms": main["f32_form_ms"],
        "shape": main["shape"], "ptxas": usage}]


def step_summary(name: str, where: str, dtype, sd: dict, batch: dict,
                 iters: int, loss: str) -> dict:
    """One train step (AMSGrad lr 1e-3) of model ``name`` from ``sd`` on
    ``where`` in ``dtype``: the train-mode forward's disparities (every
    output, the running statistics held), the step's loss and gradient
    norm, each parameter's gradient and updated value, brought to the
    CPU."""
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.nn.norm import frozen_statistics
    from stereoformer_tpu_torch.train import (
        Amsgrad,
        TrainState,
        make_train_step,
    )

    m = get_model(name, device=where, dtype=dtype)
    m.load_state_dict(sd)
    data = {k: v.to(where) for k, v in batch.items()}
    m.train()
    with torch.no_grad(), frozen_statistics(m):
        out = m(data["img_left"], data["img_right"], iters=iters)
    tx = Amsgrad(LR)
    _, metrics = make_train_step(tx, loss, iters=iters)(
        TrainState.create(m, tx), data)
    return {"disparities": torch.cat([d.flatten() for d in
                                      out["disparities"]]).cpu().double(),
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "grads": {k: p.grad.cpu().double()
                      for k, p in m.named_parameters()},
            "params": {k: p.detach().cpu().double()
                       for k, p in m.named_parameters()}}


# phase 18's gate on the card's bf16 train step, the tests' gate on the CPU
# port against JAX: each quantity no further from the CPU port's bf16 step
# than BF16_FLOOR_FACTOR times the CPU port's own floor, the largest
# distance from it of a CPU bf16 step with one bf16 ulp added at 0.1% of the
# left image's values (one run for each seed of BF16_NUDGE_SEEDS)
BF16_FLOOR_FACTOR = 1.5
BF16_NUDGE_SEEDS = (9, 10, 11, 12, 13)
# the share of gradient leaves at which the gate must be able to see a
# gradient in a wrong direction
BF16_GATE_POWER = 2 / 3


def nudged(left: torch.Tensor, seed: int) -> torch.Tensor:
    """``left`` with one bf16 ulp added at 0.1% of its values."""
    pick = np.random.default_rng(seed).random(tuple(left.shape)) < 1e-3
    out = left.clone()
    out[torch.from_numpy(pick)] *= 1 + 2.0 ** -7
    return out


def bf16_train_parity_vs_cpu() -> dict:
    """Phase 18: one bf16 train step on the card against the port's bf16
    step on the CPU, TF32 off, moderate weights: LowCNN_gru at 64x256 and
    RAFT_Stereo at 64x128, 2 iterations each (as the CPU tests take them:
    over 12 GRU iterations a nudge moves LowCNN_gru's median gradient leaf
    by more than its norm, and no gate could see a wrong direction).

    A bf16 step is chaotic at the scale of its own rounding: two summation
    orders, or one bf16 ulp changed at a few input values, move the
    backbone's gradient leaves by about half their norm. So each quantity
    is held, as the CPU tests hold the port to JAX, within
    BF16_FLOOR_FACTOR times the CPU's own floor (the largest distance of a
    nudged CPU step, BF16_NUDGE_SEEDS): the loss; the forward's
    disparities (every output, mean abs); every parameter's gradient, leaf
    by leaf, as the norm of the difference of the two gradient tensors (so
    a gradient of the right norm and the wrong direction fails), its floor
    at least one bf16 ulp of the leaf's norm; and the updated parameters
    (the norm of the difference over all leaves: AMSGrad's first step moves
    each by about lr, so a leaf's difference is the few gradients whose sign
    flips). The step's gradient norm is printed. The gate has to be able
    to see a wrong direction: a gradient of each leaf's norm in a seeded
    random direction would fail it at BF16_GATE_POWER of the leaves or
    more."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("bf16 train step: the card against the CPU port's bf16 step, "
          f"within {BF16_FLOOR_FACTOR}x the CPU's floor (one bf16 ulp at "
          f"0.1% of the left image, {len(BF16_NUDGE_SEEDS)} seeds), TF32 "
          "off:", flush=True)
    out = {}
    for name, h, w, iters, seed in (("LowCNN_gru", 64, 256, 2, 2),
                                    ("RAFT_Stereo", 64, 128, 2, 6)):
        srng = np.random.default_rng(seed)
        batch = {k: torch.from_numpy(srng.standard_normal(
            (2, h, w, 3), dtype=np.float32)) for k in ("img_left",
                                                       "img_right")}
        batch["gt_disp"] = torch.from_numpy(
            (6 + 3 * srng.standard_normal((2, h, w, 1))).astype(np.float32))
        sd = moderate_weights(name)

        def run(where, left):
            return step_summary(name, where, torch.bfloat16, sd,
                                {**batch, "img_left": left}, iters,
                                "sequence")

        cpu = run("cpu", batch["img_left"])
        card = run("cuda", batch["img_left"])
        nudges = [run("cpu", nudged(batch["img_left"], s))
                  for s in BF16_NUDGE_SEEDS]

        def dist(key, a):
            if key == "loss":
                return abs(a[key] - cpu[key])
            if key == "disparities":
                return (a[key] - cpu[key]).abs().mean().item()
            return float(torch.sqrt(sum(((a[key][k] - cpu[key][k]) ** 2)
                                        .sum() for k in cpu[key])))

        row = {}
        for key in ("loss", "disparities", "params"):
            floor = max(dist(key, n) for n in nudges)
            got = dist(key, card)
            ok = got <= BF16_FLOOR_FACTOR * floor
            print(f"  {name} {key}: card vs CPU {got:.4e}, the CPU's floor "
                  f"{floor:.4e}: {got / floor:.2f} of it "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SmokeFailure(f"{name} bf16 step {key}: the card is "
                                   f"{got} from the CPU, above "
                                   f"{BF16_FLOOR_FACTOR} x {floor}")
            row[key] = {"card_vs_cpu": got, "floor": floor}
        leaves = {}
        seen = 0
        drng = torch.Generator().manual_seed(0)
        for k, g in cpu["grads"].items():
            norm = g.norm().item()
            floor = max([2.0 ** -7 * norm] + [(n["grads"][k] - g).norm()
                                              .item() for n in nudges])
            got = (card["grads"][k] - g).norm().item()
            finite = bool(torch.isfinite(card["grads"][k]).all())
            wrong = torch.randn(g.shape, generator=drng, dtype=g.dtype)
            seen += ((wrong * (norm / wrong.norm()) - g).norm().item()
                     > BF16_FLOOR_FACTOR * floor)
            leaves[k] = {"card_vs_cpu": got, "floor": floor, "norm": norm}
            if not (finite and got <= BF16_FLOOR_FACTOR * floor):
                raise SmokeFailure(
                    f"{name} bf16 step, the gradient of {k}: the card is "
                    f"{got:.4e} from the CPU (finite {finite}), above "
                    f"{BF16_FLOOR_FACTOR} x {floor:.4e} (leaf norm "
                    f"{norm:.4e})")
        share = sorted((v["card_vs_cpu"] / v["floor"], k)
                       for k, v in leaves.items())
        rel = [v["card_vs_cpu"] / max(v["norm"], 1e-30)
               for v in leaves.values()]
        power = seen / len(leaves)
        print(f"  {name} gradients, {len(leaves)} leaves: the worst "
              f"{share[-1][1]} at {share[-1][0]:.2f} of its floor, the "
              f"median at {share[len(share) // 2][0]:.2f}; the card's "
              f"distance from the CPU relative to the leaf's norm up to "
              f"{max(rel):.3f} (median {float(np.median(rel)):.3f}) ok; a "
              f"gradient in a random direction would fail at {seen} of "
              f"them ({power:.0%}, at least {BF16_GATE_POWER:.0%} needed) "
              f"{'ok' if power >= BF16_GATE_POWER else 'FAIL'}; gradient "
              f"norm card {card['grad_norm']:.4e}, CPU "
              f"{cpu['grad_norm']:.4e}", flush=True)
        if power < BF16_GATE_POWER:
            raise SmokeFailure(f"{name} bf16 step: the floors are so wide "
                               f"that a random gradient would pass at "
                               f"{len(leaves) - seen} of {len(leaves)} "
                               f"leaves")
        row["grads"] = {"worst": share[-1][1], "worst_share": share[-1][0],
                        "median_share": share[len(share) // 2][0],
                        "max_rel": max(rel), "power": power,
                        "leaves": leaves}
        row["grad_norm"] = {"card": card["grad_norm"],
                            "cpu": cpu["grad_norm"]}
        out[name] = row
    torch.backends.cudnn.allow_tf32 = True
    return out


def bf16_cli_phase(ops, record) -> dict:
    """Phase 18: cli.train --dtype bf16 on dummy data at 320x640, B=4, 12
    iterations (phase 14's arguments, dummy:8): one epoch, then --resume to
    a second; the checkpoints hold float32 parameters, statistics and
    moments. Returns the first run's launch counts."""
    from stereoformer_tpu_torch.scripts.resume_determinism import (
        TRAINER_ARGS,
        train_run,
    )

    args = list(TRAINER_ARGS)
    args[args.index("dummy:32")] = "dummy:8"
    args += ["--dtype", "bf16"]
    print(f"cli.train --dtype bf16 LowCNN_gru dummy:8 {TRAIN_H}x{TRAIN_W} B=4 "
          f"iters={ITERS}:", flush=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        reset_counts(ops)
        first = train_run(args, root, "run", "--epochs", "1")
        launches = read_counts(ops)
        steps = sum(h["steps"] for h in first.history)
        val = len(first.val_loader)
        check_launches("cli.train --dtype bf16", launches,
                       corr_band_bf16=steps + val,
                       local_soft_argmin=ITERS * (steps + val),
                       local_soft_argmin_bwd=ITERS * steps)
        resumed = train_run(args, root, "run", "--epochs", "2", "--resume")
        ckpts = sorted(n for n in os.listdir(os.path.join(root, "run"))
                       if n.startswith("LowCNN_gru_0_"))
        state = torch.load(os.path.join(root, "run", ckpts[-1]),
                           map_location="cpu", weights_only=True)
        dtypes = {str(v.dtype) for v in state["model"].values()} | {
            str(v.dtype) for m in ("mu", "nu", "nu_max")
            for v in state["opt_state"][m].values()}
        losses = [h["loss"] for h in first.history + resumed.history]
        ok = (resumed.is_pretrain and resumed.state.step == 2 * steps
              and len(ckpts) == 2 and dtypes <= {"torch.float32",
                                                 "torch.int64"}
              and np.all(np.isfinite(losses))
              and resumed.net.compute_dtype == torch.bfloat16)
        print(f"  launches in epoch 1 ({steps} steps, {val} validation "
              f"forwards): { {k: v for k, v in launches.items() if v} }; "
              f"resumed to step {resumed.state.step}; checkpoints {ckpts}; "
              f"checkpoint dtypes {sorted(dtypes)}; mean losses "
              f"{', '.join(f'{x:.3f}' for x in losses)} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SmokeFailure("cli.train --dtype bf16: the run or its "
                               "resume failed its checks")
        record["bf16_trainer_cli"] = {"launches": launches, "losses": losses,
                                      "checkpoint_dtypes": sorted(dtypes)}
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 19: RAFT-Stereo's option sets. The upstream real-time model's two
# options that the JAX model has (n_downsample 3, n_gru_layers 2; its
# README's "Faster Implementation" runs 7 iterations), and features at 1/2
RAFT_OPTION_SETS = {"ds3_gru2": {"downsample": 3, "n_gru_layers": 2},
                    "ds1": {"downsample": 1}}
RAFT_FAST_ITERS = 7
# conv2d_fused's and conv2d_dw's sites at the option sets that move them:
# at downsample=3 layer1 and layer2 run at 1/2 and 1/4 (eval B=2 at
# 576x960, train B=4 at 320x720), at downsample=1 layer2 runs at full
# resolution, its 64 -> 96 entry routed too (16 sites a forward). name ->
# (B, H, W, C, Co), Co = C where left out
RAFT_DS3_CONVS = {
    "fnet layer1": (4, 288, 480, 64), "cnet layer1": (2, 288, 480, 64),
    "fnet layer2": (4, 144, 240, 96), "cnet layer2": (2, 144, 240, 96)}
RAFT_DS1_CONVS = {"fnet layer2 entry": (4, 576, 960, 64, 96),
                  "cnet layer2 entry": (2, 576, 960, 64, 96),
                  "fnet layer2": (4, 576, 960, 96),
                  "cnet layer2": (2, 576, 960, 96)}
RAFT_DS3_TRAIN_CONVS = {
    "fnet layer1": (8, 160, 360, 64), "cnet layer1": (4, 160, 360, 64),
    "fnet layer2": (8, 80, 180, 96), "cnet layer2": (4, 80, 180, 96)}
# the 64 -> 96 entry in the train protocol (B=4 at 320x720): conv2d_dw's
# and the dx conv's sites that no other set has
RAFT_DS1_TRAIN_CONVS = {"fnet layer2 entry": (8, 320, 720, 64, 96),
                        "cnet layer2 entry": (4, 320, 720, 64, 96)}
# the downsample=1 train step's batch: its update block runs at 1/2
# resolution, four times the default's pixels, so a smaller batch keeps it
# within the card's memory; it checks the launches and is timed alone
RAFT_DS1_TRAIN_B = 1


def raft_options_phase(ops, rng, record) -> dict:
    """Phase 19: RAFT_Stereo at the option sets, at full width; returns the
    launch counts of each path."""
    from stereoformer_tpu_torch.models import get_model

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True
    opts = RAFT_OPTION_SETS["ds3_gru2"]
    iters = RAFT_FAST_ITERS
    left, right = randn(rng, 2, H, W, 3), randn(rng, 2, H, W, 3)
    launches, rec = {}, {}
    print(f"RAFT_Stereo option sets (phase 19), eval {H}x{W} B=2 "
          f"iters={iters} test_mode, beside the default:", flush=True)

    def eval_case(label, dtype, **options):
        model = get_model("RAFT_Stereo", device="cuda", dtype=dtype,
                          **options)

        def forward():
            with torch.inference_mode():
                return model(left, right, iters=iters, test_mode=True)

        f = 2 ** options.get("downsample", 2)
        reset_counts(ops)
        out = forward()
        counts = read_counts(ops)
        d, low = out["disparities"], out["disp_low"]
        ok = (len(d) == 1 and d[0].shape == (2, H, W, 1)
              and low.shape == (2, H // f, W // f, 1)
              and d[0].dtype == torch.float32
              and bool(torch.isfinite(d[0]).all())
              and bool(torch.isfinite(low).all()))
        if not ok:
            raise SmokeFailure(f"RAFT {label}: outputs {len(d)} "
                               f"{tuple(d[0].shape)} {d[0].dtype}, disp_low "
                               f"{tuple(low.shape)}, or not finite")
        del out, d, low
        ms = time_ms(forward, reps=3, warmup=1)
        return model, counts, ms

    for dtype, key in ((torch.float32, "conv2d_fused"),
                       (torch.bfloat16, "conv2d_fused_bf16")):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        row = {}
        for label, options in (("ds3_gru2", opts), ("default", {})):
            model, counts, ms = eval_case(f"{label} {name}", dtype,
                                          **options)
            check_launches(f"RAFT {label} {name} eval", counts, **{key: 14})
            if label == "ds3_gru2":
                launches[f"raft_ds3_gru2_{name}_eval"] = counts
            row[label] = {"ms_per_batch": ms, "pairs_per_s": 2 / ms * 1e3}
            del model
        rec[f"eval_{name}"] = row
        print(f"  {name} eval: downsample=3, n_gru_layers=2 "
              f"{row['ds3_gru2']['ms_per_batch']:.2f} ms/batch, default "
              f"{row['default']['ms_per_batch']:.2f} ms/batch (the same "
              f"{iters} iterations, timed in turn; 14 {key} launches a "
              f"forward each)", flush=True)
    model, counts, ms = eval_case("ds1 f32", None, **RAFT_OPTION_SETS["ds1"])
    check_launches("RAFT ds1 f32 eval", counts, conv2d_fused=16)
    launches["raft_ds1_f32_eval"] = counts
    rec["eval_f32"]["ds1"] = {"ms_per_batch": ms,
                              "pairs_per_s": 2 / ms * 1e3}
    print(f"  float32 eval, downsample=1: {ms:.2f} ms/batch (16 "
          f"conv2d_fused launches a forward: layer2's 64 -> 96 entry in "
          f"both encoders too)", flush=True)
    del model, left, right

    print(f"  train step {RAFT_TRAIN_H}x{RAFT_TRAIN_W} B={RAFT_TRAIN_B} "
          f"iters={ITERS} sequence loss AMSGrad lr {RAFT_LR:g}, "
          f"downsample=3, n_gru_layers=2 (float32 beside the default, and "
          f"bf16):", flush=True)
    steps = {}
    for label, dtype, options, want, batch in (
            ("ds3_gru2", None, opts, {"conv2d_fused": 28, "conv2d_dw": 14},
             RAFT_TRAIN_B),
            ("default", None, {}, {"conv2d_fused": 28, "conv2d_dw": 14},
             RAFT_TRAIN_B),
            ("ds3_gru2_bf16", torch.bfloat16, opts,
             {"conv2d_fused_bf16": 28, "conv2d_fused_bf16_dx": 14,
              "conv2d_dw_bf16": 14}, RAFT_TRAIN_B),
            ("ds1", None, RAFT_OPTION_SETS["ds1"],
             {"conv2d_fused": 32, "conv2d_dw": 16}, RAFT_DS1_TRAIN_B)):
        model, tx, state, step, data = raft_train_setup(dtype, batch,
                                                        **options)
        reset_counts(ops)
        state, m = step(state, data)
        counts = read_counts(ops)
        check_launches(f"RAFT {label} train step", counts, **want)
        curve = [float(m["loss"])]
        for _ in range(3):
            state, m = step(state, data)
            curve.append(float(m["loss"]))
        grads_finite = all(bool(torch.isfinite(p.grad).all())
                           for p in model.parameters())
        if (not np.all(np.isfinite(curve)) or not curve[-1] < curve[0]
                or not grads_finite):
            raise SmokeFailure(f"RAFT {label} train: loss {curve}, finite "
                               f"gradients {grads_finite}")
        ms = time_ms(lambda: step(state, data), reps=3, warmup=1)
        steps[label] = {"ms_per_step": ms, "loss_curve": curve,
                        "batch": batch, "pairs_per_s": batch / ms * 1e3}
        if label != "default":
            launches[f"raft_{label}_train_step"] = counts
        print(f"    {label} (B={batch}): {ms:.2f} ms/step, loss over 4 steps "
              f"{', '.join(f'{x:.4f}' for x in curve)}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        del model, tx, state, step, data
    rec["train"] = steps

    print("  card vs CPU port at 64x128, TF32 off, moderate weights:",
          flush=True)
    rec["parity_vs_cpu"] = {
        label: raft_option_parity(label, options)
        for label, options in RAFT_OPTION_SETS.items()}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    srng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(srng.standard_normal((2, 64, 128, 3),
                                                      dtype=np.float32))
             for k in ("img_left", "img_right")}
    batch["gt_disp"] = torch.from_numpy(
        (6 + 3 * srng.standard_normal((2, 64, 128, 1))).astype(np.float32))
    rec["parity_vs_cpu"]["ds3_gru2_train"] = train_step_parity(
        "RAFT_Stereo", moderate_weights("RAFT_Stereo", **opts), batch,
        iters=2, param_tol=2e-6, min_share=0.85, model_kw=opts)

    print("  the kernels at the option sets' sites (TF32 off):", flush=True)
    times = record.setdefault("kernel_times", {})
    times["conv2d_fused_ds3"] = {w: fused_site(ops, rng, w, *shape)
                                 for w, shape in RAFT_DS3_CONVS.items()}
    times["conv2d_fused_ds1"] = {w: fused_site(ops, rng, w, *shape)
                                 for w, shape in RAFT_DS1_CONVS.items()}
    times["conv2d_fused_dx_ds1"] = {
        w: dx_site(ops, rng, w, *shape)
        for w, shape in RAFT_DS1_TRAIN_CONVS.items()}
    times["conv2d_dw_ds3"] = {w: dw_site(ops, rng, w, *shape)
                              for w, shape in RAFT_DS3_TRAIN_CONVS.items()}
    times["conv2d_dw_ds1"] = {w: dw_site(ops, rng, w, *shape)
                              for w, shape in RAFT_DS1_TRAIN_CONVS.items()}
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    rec["seconds"] = time.perf_counter() - t0
    record["raft_options"] = rec
    print(f"phase 19: {rec['seconds']:.1f} s", flush=True)
    return launches


def raft_option_parity(label: str, options: dict) -> dict:
    """RAFT eval at ``options`` on the card against the port on the CPU at
    64x128, 12 iterations, TF32 off, moderate weights (phase 13's
    bounds)."""
    from stereoformer_tpu_torch.models import get_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = moderate_weights("RAFT_Stereo", **options)
    srng = np.random.default_rng(5)
    li, ri = (torch.from_numpy(srng.standard_normal((2, 64, 128, 3),
                                                    dtype=np.float32))
              for _ in range(2))
    outs = {}
    for where in ("cpu", "cuda"):
        m = get_model("RAFT_Stereo", device=where, **options)
        m.load_state_dict(sd)
        with torch.inference_mode():
            o = m(li.to(where), ri.to(where), iters=ITERS)
        outs[where] = (o["disp_low"].cpu(), o["disparities"][-1].cpu())
    torch.backends.cudnn.allow_tf32 = True
    return {"disp_low_px": compare(f"RAFT {label} eval disp_low",
                                   outs["cuda"][0], outs["cpu"][0], 1e-3),
            "last_disparity_px": compare(f"RAFT {label} eval last disparity",
                                         outs["cuda"][1], outs["cpu"][1],
                                         5e-3),
            "disp_low_range_px": outs["cpu"][0].abs().max().item()}


# phase 20: the library modules no model calls, at full width.
# ResSubmoduleAttention refines a 1/4 disparity of 576x960 images (B=8)
# with a 32-channel feature; its deformable bottleneck runs deform_sample
# at DEFORM_RES_SHAPE, [8, 36, 60, 256] -> 256
RES_ATTENTION = {"B": 8, "scale": 2, "feature": 32, "out_planes": 64}
# the deformable convs' input, [B, C, H, W], and the RoI pooling's
DEFORM_MODULE_SHAPE = (8, 128, H // 8, W // 8)
ROI_SHAPE, N_ROIS = (2, 256, H // 8, W // 8), 128
# card against the CPU port in phase 20: float32 on both, TF32 off, sums in
# other orders through up to ten layers; relative to the largest output
MODULE_RTOL = 1e-4
# the hourglass's gradients through train-mode BatchNorm, sums over 3.3M
# positions: float32 on the CPU is 3.2e-4 to 1.2e-3 from float64 norm-wise
# under moderate_weights, and the card, TF32 off, up to 1.28 times that
# (this phase on an H100 80GB HBM3 at 700 W); each gradient's distance from
# float64 on the card is held to this many times the CPU float32's
HOURGLASS_FLOOR_FACTOR = 3.0


def seeded_module(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``module`` with ``moderate_weights(module, seed)`` loaded."""
    module.load_state_dict(moderate_weights(module, seed))
    return module


def module_vs_cpu(label: str, module, inputs: list, batch_slice=None,
                  rtol: float = MODULE_RTOL, reps: int = 5) -> dict:
    """One forward of ``module`` on the card (inference, TF32 off), timed
    by CUDA events over ``reps`` calls, and the same module on the CPU on
    the same inputs (the first ``batch_slice`` samples of each where given:
    the module runs each sample alone) -> its numbers."""
    import copy

    cpu = copy.deepcopy(module).cpu()
    card = module.cuda()
    args = [a.cuda() for a in inputs]

    def forward():
        with torch.inference_mode():
            return card(*args)

    got = forward()
    ms = time_ms(forward, reps=reps, warmup=1)
    sl = slice(None) if batch_slice is None else slice(0, batch_slice)
    with torch.inference_mode():
        want = cpu(*[a[sl] for a in inputs])
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.isfinite(g).all():
            raise SmokeFailure(f"{label}: output {i} not finite")
        top = w.abs().max().item()
        err = max(err, compare(
            f"{label} output {i} {tuple(g.shape)} (CPU on "
            f"{'all' if batch_slice is None else batch_slice} samples, "
            f"largest |out| {top:.3g})", g[sl].cpu(), w, rtol * top))
    print(f"    {label}: {ms:.3f} ms a forward on the card", flush=True)
    return {"ms": ms, "max_abs_err": err}


def library_modules_phase(ops, rng, record) -> dict:
    """Phase 20: the modules of the deformable-conv and library slices on
    the card at full width, each against the CPU port and timed; returns
    the launch counts of each path."""
    from stereoformer_tpu_torch import nn as pnn

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    launches, rec = {}, {}
    print("library modules on the card (phase 20), TF32 off, against the "
          "CPU port:", flush=True)
    ra = RES_ATTENTION
    Bm, h4, w4 = ra["B"], H // 4, W // 4
    srng = np.random.default_rng(11)
    imgs = [torch.from_numpy(srng.uniform(0, 1, (Bm, H, W, 3)).astype(
        np.float32)) for _ in range(2)]
    disp = torch.from_numpy(srng.uniform(0, 48, (Bm, h4, w4, 1)).astype(
        np.float32))
    feat = torch.from_numpy(srng.standard_normal(
        (Bm, h4, w4, ra["feature"])).astype(np.float32))
    for deform in (False, True):
        label = f"ResSubmoduleAttention(deform={deform})"
        mod = seeded_module(pnn.ResSubmoduleAttention(
            ra["scale"], ra["feature"], ra["out_planes"], deform), 12).eval()
        reset_counts(ops)
        with torch.inference_mode():
            mod.cuda()(*(a.cuda() for a in (imgs[0], imgs[1], disp, feat)))
        counts = read_counts(ops)
        check_launches(f"{label} forward", counts,
                       **({"deform_sample": 1} if deform else {}))
        launches[f"res_attention_deform_{deform}"] = counts
        rec[label] = module_vs_cpu(label, mod, [imgs[0], imgs[1], disp,
                                                feat], batch_slice=2)
        del mod
    del imgs, disp, feat
    rec["deform_sample_c256"] = deform_site(
        ops, rng, "ResSubmoduleAttention bottleneck", DEFORM_RES_SHAPE)

    # the 3-D hourglass, train mode: forward and one backward
    f = 32
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, f, 48, H // 4, W // 4)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(14).standard_normal(
        x.shape).astype(np.float32))
    runs = {}
    for where, dt in (("cpu64", torch.float64), ("cpu", torch.float32),
                      ("cuda", torch.float32)):
        dev = "cuda" if where == "cuda" else "cpu"
        m = seeded_module(pnn.Hourglass3D(f), 15).train().to(dev, dt)
        xi = x.clone().to(dev, dt).requires_grad_(True)
        reset_counts(ops)
        out = m(xi)
        (out * g.to(dev, dt)).sum().backward()
        counts = read_counts(ops)
        runs[where] = (out.detach().cpu().double(),
                       {"x": xi.grad.cpu().double(),
                        **{k: p.grad.cpu().double()
                           for k, p in m.named_parameters()}},
                       {k: v.cpu().double()
                        for k, v in m.state_dict().items()})
    check_launches("Hourglass3D forward and backward", counts)
    launches["hourglass3d"] = counts
    gc_ = g.cuda()

    def fwd_bwd():
        (m(xi) * gc_).sum().backward()

    ms = time_ms(fwd_bwd, reps=3, warmup=1)
    (o64, g64, _), (oc, gcpu, sc), (og, gg, sg) = (
        runs["cpu64"], runs["cpu"], runs["cuda"])
    top = oc.abs().max().item()
    hg_err = compare("Hourglass3D(32) train forward [1, 32, 48, 144, 240]",
                     og, oc, MODULE_RTOL * top)

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    # each gradient held to the float32 floor: its distance from float64
    # on the card no more than HOURGLASS_FLOOR_FACTOR times the CPU's
    leaves = {k: (rel(gg[k], gcpu[k]), rel(gg[k], g64[k]), rel(gcpu[k],
                                                               g64[k]))
              for k in g64}
    worst = max(v[0] for v in leaves.values())
    ratio = max(v[1] / v[2] for v in leaves.values())
    stats = max((sg[k] - sc[k]).abs().max().item() for k in sc
                if k.endswith(("running_mean", "running_var")))
    ok = ratio <= HOURGLASS_FLOOR_FACTOR and stats <= 1e-4
    floor = [v[2] for v in leaves.values()]
    print(f"  Hourglass3D backward, the input's and every parameter's "
          f"gradient, norm-wise: card vs CPU float32 up to {worst:.2e}; "
          f"from float64 the CPU's float32 {min(floor):.2e} to "
          f"{max(floor):.2e}, the card's at most {ratio:.2f} times the "
          f"CPU's (tolerance {HOURGLASS_FLOOR_FACTOR:g}); running "
          f"statistics after the call within {stats:.2e} (1e-4) "
          f"{'ok' if ok else 'FAIL'}; {ms:.2f} ms a forward and backward on "
          f"the card", flush=True)
    if not ok:
        raise SmokeFailure("Hourglass3D: card and CPU disagree")
    rec["Hourglass3D"] = {"ms_forward_backward": ms, "max_abs_err": hg_err,
                          "grad_rel_err": worst, "grad_floor": floor,
                          "grad_vs_floor": ratio, "stats_err": stats}
    del x, g, gc_, runs, m, xi, out

    # cost volume pyramid: 32-channel features at 1/4, 1/8 and 1/16
    prng = np.random.default_rng(16)
    lefts, rights = ([torch.from_numpy(prng.standard_normal(
        (2, H // s, W // s, 32)).astype(np.float32)) for s in (4, 8, 16)]
        for _ in range(2))
    for mode in ("correlation", "concat", "difference"):
        reset_counts(ops)
        lc, rc = [a.cuda() for a in lefts], [a.cuda() for a in rights]
        got = pnn.cost_volume_pyramid(lc, rc, 192, mode)
        counts = read_counts(ops)
        check_launches(f"cost_volume_pyramid {mode}", counts,
                       **({"corr_band": 3} if mode == "correlation" else {}))
        launches[f"cost_volume_pyramid_{mode}"] = counts
        ms = time_ms(lambda: pnn.cost_volume_pyramid(lc, rc, 192, mode),
                     reps=3, warmup=1)
        want = pnn.cost_volume_pyramid(lefts, rights, 192, mode)
        err = max(compare(f"cost_volume_pyramid {mode} level {i} "
                          f"{tuple(w.shape)}", gv.cpu(), w,
                          MODULE_RTOL * w.abs().max().item())
                  for i, (gv, w) in enumerate(zip(got, want)))
        print(f"    cost_volume_pyramid {mode}: {ms:.3f} ms on the card",
              flush=True)
        rec[f"cost_volume_pyramid_{mode}"] = {"ms": ms, "max_abs_err": err}
        del got, want, lc, rc
    del lefts, rights

    # the deformable convs at [8, 128, 72, 120] -> 128
    Bd, Cd, Hd, Wd = DEFORM_MODULE_SHAPE
    drng = np.random.default_rng(17)

    def rand(*shape):
        return torch.from_numpy(drng.standard_normal(shape).astype(
            np.float32))

    x = rand(Bd, Cd, Hd, Wd)
    off = 1.5 * rand(Bd, 18, Hd, Wd)
    mask = torch.sigmoid(rand(Bd, 9, Hd, Wd))
    normal = rand(Bd, 32, Hd, Wd)
    cases = [
        ("ModulatedDeformConv", pnn.ModulatedDeformConv(Cd, Cd),
         [x, off, mask]),
        ("ModulatedDeformNormal", pnn.ModulatedDeformNormal(
            Cd, Cd, normal_channels=32), [x, normal]),
        ("DeformConvV1", pnn.DeformConvV1(Cd, Cd), [x, off]),
        ("DeformConvV1Pack", pnn.DeformConvV1Pack(Cd, Cd), [x]),
        ("DeformConvV1Pack stride 2", pnn.DeformConvV1Pack(Cd, Cd,
                                                           stride=2), [x])]
    for i, (label, mod, inputs) in enumerate(cases):
        reset_counts(ops)
        rec[label] = module_vs_cpu(label, seeded_module(mod, 20 + i),
                                   inputs, batch_slice=1, reps=3)
        check_launches(label, read_counts(ops))
        launches[label.replace(" ", "_")] = read_counts(ops)
    del x, off, mask, normal, cases

    # deformable PS-RoI pooling: 128 RoIs in 576x960 image coordinates
    feats = rand(*ROI_SHAPE)
    x1 = drng.uniform(-20, 0.8 * W, N_ROIS)
    y1 = drng.uniform(-20, 0.8 * H, N_ROIS)
    rois = torch.from_numpy(np.stack([
        drng.integers(0, ROI_SHAPE[0], N_ROIS), x1, y1,
        x1 + drng.uniform(16, W / 3, N_ROIS),
        y1 + drng.uniform(16, H / 3, N_ROIS)], 1).astype(np.float32))
    pack = seeded_module(pnn.DeformRoIPoolingPack(
        ROI_SHAPE[1], pooled_size=7, spatial_scale=1 / 8, trans_std=0.1,
        sample_per_part=4), 30)
    reset_counts(ops)
    rec["DeformRoIPoolingPack"] = module_vs_cpu(
        "DeformRoIPoolingPack", pack, [feats, rois])
    check_launches("DeformRoIPoolingPack", read_counts(ops))
    launches["DeformRoIPoolingPack"] = read_counts(ops)

    # SepConvGRU(128) at 1/8 of 576x960, B=8
    gru = seeded_module(pnn.SepConvGRU(128, 192 + 128), 31)
    hx = [torch.tanh(rand(8, 128, H // 8, W // 8)),
          rand(8, 192 + 128, H // 8, W // 8)]
    reset_counts(ops)
    rec["SepConvGRU"] = module_vs_cpu("SepConvGRU(128)", gru, hx,
                                      batch_slice=2)
    check_launches("SepConvGRU", read_counts(ops))
    launches["SepConvGRU"] = read_counts(ops)
    torch.backends.cudnn.allow_tf32 = True
    rec["seconds"] = time.perf_counter() - t0
    record["library_modules"] = rec
    print(f"phase 20: {rec['seconds']:.1f} s", flush=True)
    return launches


def add_option_site_times(rows: list, record) -> None:
    """Rows 4, 6 and 7 (conv2d_fused, conv2d_dw, deform_sample) gain the
    option sets' and the residual head's shapes, each site's time beside
    its bounds."""
    times = record["kernel_times"]
    keep = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_tf32x3_ms", "library_ms", "plan")
    new = {"conv2d_fused": {
               "raft_downsample3": times["conv2d_fused_ds3"],
               "raft_downsample1": times["conv2d_fused_ds1"],
               "raft_downsample1_dx": times["conv2d_fused_dx_ds1"]},
           "conv2d_dw": {"raft_downsample3_train": times["conv2d_dw_ds3"],
                         "raft_downsample1_train": times["conv2d_dw_ds1"]},
           "deform_sample": {"res_attention_c256": {
               "bottleneck": record["library_modules"]["deform_sample_c256"]}}}
    for row in rows:
        for key, sites in new.get(row["name"], {}).items():
            row[key] = {w: {k: v for k, v in site.items() if k in keep}
                        for w, site in sites.items()}


def device_busy(fn) -> dict:
    """Wall time of one call of ``fn`` under ``torch.profiler`` tracing the
    device only (a lighter trace than ``profile``'s, which also records
    every host op), and the device time of its GPU events."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"wall_ms": wall_ms,
            "device_ms": sum(_device_us(e) for e in events) / 1e3,
            "gpu_events": sum(e.count for e in events)}


def profile(fn, label: str, kernels=()) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the device time of the kernels whose names contain one of ``kernels``.
    Reports "not measured" when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((_device_us(e), e.count, e.key) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and _device_us(e) > 0), reverse=True)
    if not rows:
        print("  profiler saw no device time: not measured", flush=True)
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    busy_ms = sum(r[0] for r in rows) / 1e3
    n_kernels = sum(r[1] for r in rows)
    print(f"  profile of one {label}: {wall_ms:.1f} ms wall (profiled), "
          f"{busy_ms:.1f} ms device busy ({100 * busy_ms / wall_ms:.0f}%), "
          f"{n_kernels} GPU events", flush=True)
    for us, count, key in rows[:10]:
        print(f"    {us / 1e3:8.2f} ms  x{count:<5d} {key[:90]}")
    out = {"wall_ms": wall_ms, "device_ms": busy_ms, "gpu_events": n_kernels,
           "top": [{"ms": us / 1e3, "count": c, "name": k}
                   for us, c, k in rows[:40]]}
    if kernels:
        mine = {name: sum(us for us, _, key in rows if name in key) / 1e3
                for name in kernels}
        print("  of which the port's kernels: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in mine.items())
            + f" ({100 * sum(mine.values()) / busy_ms:.0f}% of device time)",
            flush=True)
        out["kernels_ms"] = mine
    return out


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
