#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stereoformer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]     # from the root of a checkout

Needs one CUDA device and nvcc; imports nothing of JAX. Phases, in order;
any failure exits nonzero and prints no result:

1. the card's name and power limit, as nvidia-smi gives them;
2. build every CUDA kernel of the main paths from csrc/, one nvcc per
   source, all at once;
3. each kernel against its plain PyTorch version at the main paths' shapes
   and at edge inputs, with the tolerance stated: the two forward kernels,
   local_soft_argmin's backward kernel, and corr_band's backward (torch
   ops) against autograd of its plain version;
4. LowCNN_gru eval through get_model at 576x960, B=8, 12 GRU iterations,
   float32, random weights from seed 0: launch counts (corr_band once,
   local_soft_argmin once per iteration, no backward), shapes, finiteness
   and range; the steady-state time with CUDA events; a profiler breakdown
   of one forward;
5. the LowCNN_gru train step through train.make_train_step at 320x640,
   B=4 and B=8, 12 GRU iterations, sequence loss, AMSGrad lr 1e-3, float32:
   launch counts per step (corr_band 1, local_soft_argmin 12, its backward
   12), a finite loss that falls over 5 steps on one batch, ms/step and
   pairs/s, peak memory, a profiler breakdown of one B=4 step;
6. each kernel's device time beside its bound and its plain version's;
7. parity of the card against the port on the CPU at 64x256 (TF32 off):
   the eval forward, and one train step (loss, gradient norm, updated
   parameters);
8. one JSON line with each kernel's numbers; the last line says the run
   was ok and names the device.

With --json, everything measured (and the profiles' top kernels) is also
written to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H, W, B, ITERS = 576, 960, 8, 12
TRAIN_H, TRAIN_W, TRAIN_BATCHES, LR = 320, 640, (4, 8), 1e-3
# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 outside tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

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
}

# TPU kernels not yet ported that a model calls: the least time this card
# could take for one call at its caller's shapes, float32
# (name -> (call, bytes, operations)). Row 4: a RAFT encoder layer1 3x3
# conv 64 -> 64 at 1/2 resolution, RAFT eval B=2 at 576x960 as bench.py
# runs it; row 6: that conv's weight gradient in RAFT training, B=4 at
# 320x720.
UNPORTED = {
    "conv2d.py:218 _forward": (
        "x [2,288,480,64], w [3,3,64,64] -> [2,288,480,64]",
        2 * 2 * 288 * 480 * 64 * 4 + 9 * 64 * 64 * 4,
        2 * 9 * 64 * 64 * 2 * 288 * 480),
    "dw_conv.py:118 conv2d_dw_pallas": (
        "x, g [4,160,360,64] -> dw [3,3,64,64]",
        2 * 4 * 160 * 360 * 64 * 4 + 9 * 64 * 64 * 4,
        2 * 9 * 64 * 64 * 4 * 160 * 360),
}


def unported_bounds() -> dict:
    out = {}
    for name, (call, nbytes, nops) in UNPORTED.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS_PER_S * 1e3
        out[name] = {"call": call, "mb": nbytes / 1e6, "gflop": nops / 1e9,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"  bound of {name} at {call}: {max(t_bytes, t_ops) * 1e3:.1f} "
              f"us by {out[name]['bound_by']} ({nbytes / 1e6:.1f} MB, "
              f"{nops / 1e9:.2f} GFLOP)", flush=True)
    return out


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


def device_ms(fn, reps: int, match: str = "") -> float:
    """Mean device time per call of ``fn``: the profiler's GPU events (the
    kernels whose name contains ``match``, or every kernel, copy and fill
    ``fn`` launches), without the host's launch overhead."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_device_us(e) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and match in e.key)
    if total_us <= 0:
        raise SmokeFailure(f"profiler saw no device time for {match or fn}")
    return total_us / 1e3 / reps


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
    ops.local_soft_argmin.launches = 0
    ops.local_soft_argmin.backward_launches = 0


def read_counts(ops) -> dict:
    torch.cuda.synchronize()
    return {"corr_band": ops.correlation_volume.launches,
            "local_soft_argmin": ops.local_soft_argmin.launches,
            "local_soft_argmin_bwd": ops.local_soft_argmin.backward_launches}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement here")
    opt = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
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
    for name, log in kernels.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(0)
    err = check_kernels(ops, rng)
    record["max_abs_err"] = err

    launches = {"eval_forward": eval_phase(ops, rng, record)}
    for batch in TRAIN_BATCHES:
        # every batch size must give the same counts per step
        launches["train_step"] = train_phase(
            ops, batch, record, profile_it=batch == TRAIN_BATCHES[0])
    record["launches"] = launches

    rows = kernel_rows(ops, rng, err, launches, record)
    record["kernels"] = rows
    record["unported_bounds"] = unported_bounds()
    record["parity_vs_cpu"] = parity_vs_cpu(record)
    record["seconds"] = time.perf_counter() - t_start

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
    for shape in ((B, H8, W8, C), (4, *T8, C), (1, 4, 10, 64),
                  (2, 5, 97, 40), (1, 2, 300, 64)):
        left, right = randn(rng, *shape), randn(rng, *shape)
        e = compare(f"corr_band {shape}",
                    ops.correlation_volume(left, right, D),
                    ops.correlation_volume_plain(left, right, D), corr_tol)
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


def eval_phase(ops, rng, record) -> dict:
    """Phase 4: the eval forward at full size; returns its launch counts."""
    from stereoformer_tpu_torch.models import get_model

    H8, W8, D = H // 8, W // 8, 24
    print(f"LowCNN_gru eval {H}x{W} B={B} iters={ITERS} float32:", flush=True)
    model = get_model("LowCNN_gru", device="cuda")
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
    if launches != {"corr_band": 1, "local_soft_argmin": ITERS,
                    "local_soft_argmin_bwd": 0}:
        raise SmokeFailure(f"eval launches {launches}, expected corr_band 1,"
                           f" local_soft_argmin {ITERS} and no backward")
    disps = out["disparities"]
    if out["disp_low"].shape != (B, H8, W8, 1) or len(disps) != ITERS:
        raise SmokeFailure("unexpected output structure")
    for d in disps:
        if d.shape != (B, H, W, 1):
            raise SmokeFailure(f"disparity shape {tuple(d.shape)}")
    stacked = torch.stack(disps)
    lo, hi = stacked.min().item(), stacked.max().item()
    finite = bool(torch.isfinite(stacked).all()) and bool(
        torch.isfinite(out["disp_low"]).all())
    # candidates lie in [0, D-1] coarse px; the convex upsample blends 8x
    # of them with zero padding at the border, so [0, 8(D-1)] full-res px
    print(f"  outputs finite={finite}, range {lo:.3f}..{hi:.3f} px",
          flush=True)
    if not finite or lo < 0 or hi > 8 * (D - 1) + 1e-3:
        raise SmokeFailure("outputs not finite or out of [0, 8(D-1)]")
    del out, disps, stacked

    timing = {}
    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        ms = time_ms(forward, reps=10)
        key = "tf32_convs" if tf32 else "strict_f32"
        timing[key] = {"ms_per_batch": ms, "pairs_per_s": B / ms * 1e3}
        print(f"  {key} (cudnn.allow_tf32={tf32}, matmul allow_tf32="
              f"{torch.backends.cuda.matmul.allow_tf32}): {ms:.2f} ms/batch, "
              f"{B / ms * 1e3:.2f} pairs/s", flush=True)
    torch.backends.cudnn.allow_tf32 = True
    record["eval"] = timing
    record["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # where one forward's device time goes (profiler, informative)
    record["profile"] = profile(forward, "forward")
    return launches


def train_phase(ops, batch: int, record, profile_it: bool = False) -> dict:
    """Phase 5: the train step at full size with ``batch`` pairs; returns
    its launch counts per step."""
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.train import (
        Amsgrad,
        TrainState,
        compute_loss,
        make_train_step,
    )

    print(f"LowCNN_gru train step {TRAIN_H}x{TRAIN_W} B={batch} "
          f"iters={ITERS} sequence loss AMSGrad lr {LR:g} float32:",
          flush=True)
    torch.backends.cudnn.allow_tf32 = True
    model = get_model("LowCNN_gru", device="cuda")
    tx = Amsgrad(LR)
    state = TrainState.create(model, tx)
    step = make_train_step(tx, "sequence", iters=ITERS)
    trng = np.random.default_rng(3)
    shape = (batch, TRAIN_H, TRAIN_W)
    data = {"img_left": randn(trng, *shape, 3),
            "img_right": randn(trng, *shape, 3),
            "gt_disp": torch.from_numpy(
                (40 + 10 * trng.standard_normal(shape + (1,)))
                .astype(np.float32)).cuda()}

    torch.cuda.reset_peak_memory_stats()
    reset_counts(ops)
    state, m = step(state, data)
    launches = read_counts(ops)
    print(f"  launches in one step: {launches}", flush=True)
    if launches != {"corr_band": 1, "local_soft_argmin": ITERS,
                    "local_soft_argmin_bwd": ITERS}:
        raise SmokeFailure(
            f"train step launches {launches}, expected corr_band 1, "
            f"local_soft_argmin {ITERS}, local_soft_argmin_bwd {ITERS}")
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

    out = {"loss_curve": curve}
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
        return compute_loss("sequence", o, data["gt_disp"])

    parts = {"forward_loss": forward_loss,
             "forward_backward": lambda: forward_loss().backward(),
             "optimizer": lambda: tx.step(state.opt_state, params, grads)}
    out["parts_ms"] = {k: time_ms(fn, reps=4, warmup=1)
                       for k, fn in parts.items()}
    print("  parts of a step: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in out["parts_ms"].items()), flush=True)
    if profile_it:
        out["profile"] = profile(one_step, "train step")
    record[f"train_b{batch}"] = out
    return launches


def kernel_rows(ops, rng, err, launches, record) -> list:
    """Phase 6: each kernel at its main path's shapes: device time per
    launch (and per call of its wrapper, host overhead included), the plain
    version's device time, the bound."""
    dev = torch.device("cuda")
    D, S, C = 24, 21, 256
    eval_shape = (B, H // 8, W // 8)
    train_shape = (4, TRAIN_H // 8, TRAIN_W // 8)

    def corr_work(shape):
        feats_l, feats_r = randn(rng, *shape, C), randn(rng, *shape, C)
        npix = int(np.prod(shape))
        band = shape[0] * shape[1] * (D * shape[2] - D * (D - 1) // 2)
        return ((2 * npix * C + npix * D) * 4, 2 * C * band,
                lambda: ops.correlation_volume(feats_l, feats_r, D),
                lambda: ops.correlation_volume_plain(feats_l, feats_r, D),
                50, 5)

    def local_work(shape):
        vol = randn(rng, *shape, D)
        cands = torch.from_numpy(edge_candidates(rng, shape + (S,), D)).to(dev)
        npix = int(np.prod(shape))
        # ~20 operations per candidate: clip, floor, two hat taps, max, exp,
        # sums (csrc/local_soft_argmin.cu)
        return (npix * (D + S + 1) * 4, 20 * npix * S,
                lambda: ops.local_soft_argmin(vol, cands),
                lambda: ops.local_soft_argmin_plain(vol, cands), 200, 20)

    def bwd_work(shape):
        vol = randn(rng, *shape, D).requires_grad_(True)
        cands = torch.from_numpy(edge_candidates(rng, shape + (S,), D)).to(dev)
        cands.requires_grad_(True)
        g = randn(rng, *shape, 1)
        out = ops.local_soft_argmin(vol, cands)
        npix = int(np.prod(shape))
        # reads vol, cand, g; writes dvol, dcand. ~35 operations per
        # candidate: the forward's, then the softmax VJP and four hat terms
        return (npix * (2 * D + 2 * S + 1) * 4, 35 * npix * S,
                lambda: torch.autograd.grad(out, (vol, cands), g,
                                            retain_graph=True),
                lambda: ops.local_soft_argmin_backward_plain(
                    vol.detach(), cands.detach(), g), 200, 20)

    # the forward kernels at the eval shapes (slice 1's main path) and at
    # the train shapes; the backward at the train shapes and the eval shapes
    work = {"corr_band": (corr_work, eval_shape, train_shape),
            "local_soft_argmin": (local_work, eval_shape, train_shape),
            "local_soft_argmin_bwd": (bwd_work, train_shape, eval_shape)}
    rows, extra = [], {}
    for name, (make, main_shape, other_shape) in work.items():
        times = {}
        for shape in (main_shape, other_shape):
            nbytes, nops, kern, plain, reps, plain_reps = make(shape)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / F32_FLOPS_PER_S * 1e3
            # each timed function launches its own kernel only
            times[shape] = {
                "ms": device_ms(kern, reps, match=name),
                "call_ms": time_ms(kern, reps),
                "plain_ms": device_ms(plain, plain_reps),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "mb": nbytes / 1e6,
            }
            t = times[shape]
            print(f"  {name} {shape}: {t['ms'] * 1e3:.1f} us on the device "
                  f"(bound {t['bound_ms'] * 1e3:.2f} us, {t['mb']:.2f} MB), "
                  f"{t['call_ms'] * 1e3:.1f} us per wrapper call, plain "
                  f"{t['plain_ms'] * 1e3:.1f} us", flush=True)
        main = times[main_shape]
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
        extra[name] = {str(list(k)): v for k, v in times.items()}
    record["kernel_times"] = extra

    # corr_band's backward, plain torch ops, at the train shapes: reads L, R
    # and the cotangent, writes dL and dR
    shape = train_shape
    left, right = randn(rng, *shape, C), randn(rng, *shape, C)
    g = randn(rng, *shape, D)
    npix = int(np.prod(shape))
    nbytes = (4 * npix * C + npix * D) * 4
    ms = device_ms(lambda: ops.correlation_volume_backward(left, right, g), 20)
    record["corr_band_backward"] = {
        "shape": list(shape), "ms": ms, "mb": nbytes / 1e6,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    print(f"  corr_band backward (torch ops) {shape}: {ms * 1e3:.1f} us on "
          f"the device (bound {nbytes / HBM_BYTES_PER_S * 1e6:.1f} us, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return rows


def parity_vs_cpu(record) -> dict:
    """Phase 7: the card against the port on the CPU at 64x256, TF32 off,
    moderate weights: the conv weights scaled to sqrt(1.25/fan_in) keep the
    volume's softmax neither flat nor one-hot; he-normal weights make it
    nearly one-hot, and float32 rounding then grows over the GRU steps."""
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.train import (
        Amsgrad,
        TrainState,
        make_train_step,
    )
    from stereoformer_tpu_torch.weights import seeded_state_dict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = seeded_state_dict(get_model("LowCNN_gru", device="cpu"), seed=1)
    for k, v in sd.items():
        if v.dim() == 4:
            sd[k] = v * np.sqrt(1.25 / 2.0)
    srng = np.random.default_rng(2)
    li, ri = (torch.from_numpy(srng.standard_normal((2, 64, 256, 3),
                                                    dtype=np.float32))
              for _ in range(2))
    gt = torch.from_numpy(
        (40 + 10 * srng.standard_normal((2, 64, 256, 1))).astype(np.float32))

    small, stepped = {}, {}
    for where in ("cpu", "cuda"):
        m = get_model("LowCNN_gru", device=where)
        m.load_state_dict(sd)
        with torch.inference_mode():
            o = m(li.to(where), ri.to(where), iters=ITERS)
        small[where] = (o["disp_low"].cpu(), o["disparities"][-1].cpu())
        tx = Amsgrad(LR)
        state, metrics = make_train_step(tx, "sequence", iters=2)(
            TrainState.create(m, tx),
            {"img_left": li.to(where), "img_right": ri.to(where),
             "gt_disp": gt.to(where)})
        stepped[where] = (
            {k: float(v) for k, v in metrics.items()},
            {k: p.detach().cpu() for k, p in m.named_parameters()},
            {k: p.grad.cpu() for k, p in m.named_parameters()})
    print("card vs CPU port at 64x256, TF32 off:", flush=True)
    parity = {
        # f32 on both, sums in other orders; the last disparity has been
        # through 12 GRU steps
        "disp_low_px": compare("eval disp_low", small["cuda"][0],
                               small["cpu"][0], 1e-3),
        "last_disparity_px": compare("eval last disparity", small["cuda"][1],
                                     small["cpu"][1], 5e-3),
    }
    (mc, pc, gc), (mg, pg, gg) = stepped["cpu"], stepped["cuda"]
    # the loss is a mean over 65536 pixels of ~50 px errors: relative 1e-5;
    # the gradient norm is dominated by the backbone's leaves, where ReLU
    # inputs within float32 rounding of 0 pass or block gradient differently
    # (tests/test_torch_train.py measures ~0.5% per leaf): relative 1e-3
    for key, rtol in (("loss", 1e-5), ("epe", 1e-5), ("grad_norm", 1e-3)):
        rel = abs(mg[key] - mc[key]) / abs(mc[key])
        print(f"  train step {key}: card {mg[key]:.6f}, CPU {mc[key]:.6f}, "
              f"relative {rel:.2e} (tolerance {rtol:g}) "
              f"{'ok' if rel <= rtol else 'FAIL'}", flush=True)
        if not rel <= rtol:
            raise SmokeFailure(f"train step {key}: relative error {rel}")
        parity[f"train_{key}_rel"] = rel
    # AMSGrad's first step moves each parameter by ~lr whatever |g|: held to
    # 2 lr everywhere, and to 1e-6 where the gradient's sign is settled
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
    ok = worst_all <= 2 * LR + 1e-6 and worst_settled <= 1e-6 and share >= 0.95
    print(f"  train step updated parameters: max diff {worst_all:.2e} "
          f"(<= 2 lr), {worst_settled:.2e} where the gradient's sign is "
          f"settled (<= 1e-6, {100 * share:.2f}% of them) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure("train step: updated parameters disagree")
    parity.update({"train_param_max_diff": worst_all,
                   "train_param_settled_max_diff": worst_settled,
                   "train_param_settled_share": share})
    torch.backends.cudnn.allow_tf32 = True
    return parity


def profile(fn, label: str) -> dict:
    """Device time by kernel over one call of ``fn`` (torch.profiler).
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
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "gpu_events": n_kernels,
            "top": [{"ms": us / 1e3, "count": c, "name": k}
                    for us, c, k in rows[:40]]}


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
