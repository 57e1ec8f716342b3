#!/usr/bin/env python3
"""Smoke run of the PyTorch port (stereoformer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]     # from the root of a checkout

Needs one CUDA device and nvcc; imports nothing of JAX. Phases, in order;
any failure exits nonzero and prints no result:

1. the card's name and power limit, as nvidia-smi gives them;
2. build every CUDA kernel of the main path from csrc/, one nvcc per
   source, all at once;
3. each kernel against its plain PyTorch version at the main path's shapes
   and at edge inputs, with the tolerance stated;
4. LowCNN_gru eval through get_model at 576x960, B=8, 12 GRU iterations,
   float32, random weights from seed 0: launch counts (corr_band once,
   local_soft_argmin once per iteration), shapes, finiteness and range;
   the steady-state time with CUDA events; each kernel's time beside its
   bound and its plain version's; a profiler breakdown of one forward;
5. parity of the card against the port on the CPU at 64x256 (TF32 off);
6. one JSON line with each kernel's numbers; the last line says the run
   was ok and names the device.

With --json, everything measured (and the profile's top kernels) is also
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
}


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement here")
    opt = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from stereoformer_tpu_torch import kernels, ops
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.weights import seeded_state_dict

    dev = torch.device("cuda")
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

    # 3. each kernel against its plain version
    rng = np.random.default_rng(0)
    H8, W8, C, D, S = H // 8, W // 8, 256, 24, 21
    print("kernels vs plain:", flush=True)
    err = {"corr_band": 0.0, "local_soft_argmin": 0.0}

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    # float32 dots over C in another order than the plain version's
    corr_tol = 1e-5
    for shape in ((B, H8, W8, C), (1, 4, 10, 64), (2, 5, 97, 40),
                  (1, 2, 300, 64)):
        left, right = randn(*shape), randn(*shape)
        e = compare(f"corr_band {shape}", ops.correlation_volume(left, right, D),
                    ops.correlation_volume_plain(left, right, D), corr_tol)
        err["corr_band"] = max(err["corr_band"], e)
    # disparities in px up to ~26; exp and division in another order
    local_tol = 1e-4
    for shape in ((B, H8, W8), (1, 7, 19)):
        vol = randn(*shape, D)
        cands = torch.from_numpy(edge_candidates(rng, shape + (S,), D)).to(dev)
        e = compare(f"local_soft_argmin {shape}",
                    ops.local_soft_argmin(vol, cands),
                    ops.local_soft_argmin_plain(vol, cands), local_tol)
        err["local_soft_argmin"] = max(err["local_soft_argmin"], e)
    record["max_abs_err"] = err

    # 4. the main path
    print(f"LowCNN_gru eval {H}x{W} B={B} iters={ITERS} float32:", flush=True)
    model = get_model("LowCNN_gru", device="cuda")
    left = randn(B, H, W, 3)
    right = randn(B, H, W, 3)

    def forward():
        with torch.inference_mode():
            return model(left, right, iters=ITERS)

    ops.correlation_volume.launches = 0
    ops.local_soft_argmin.launches = 0
    out = forward()
    torch.cuda.synchronize()
    launches = {"corr_band": ops.correlation_volume.launches,
                "local_soft_argmin": ops.local_soft_argmin.launches}
    print(f"  launches in one forward: {launches}", flush=True)
    record["launches"] = launches
    if launches != {"corr_band": 1, "local_soft_argmin": ITERS}:
        raise SmokeFailure(f"main path launches {launches}, expected "
                           f"corr_band 1 and local_soft_argmin {ITERS}")
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

    # each kernel at the main path's shapes: device time per launch (and
    # per call of its wrapper, host overhead included), plain version's
    # device time, bound
    feats_l, feats_r = randn(B, H8, W8, C), randn(B, H8, W8, C)
    vol = randn(B, H8, W8, D)
    cands = torch.from_numpy(edge_candidates(rng, (B, H8, W8, S), D)).to(dev)
    npix = B * H8 * W8
    band = B * H8 * (D * W8 - D * (D - 1) // 2)   # (w, d) pairs with w >= d
    work = {
        "corr_band": ((2 * npix * C + npix * D) * 4, 2 * C * band,
                      lambda: ops.correlation_volume(feats_l, feats_r, D),
                      lambda: ops.correlation_volume_plain(feats_l, feats_r, D),
                      50, 5),
        # ~20 operations per candidate: clip, floor, two hat taps, max,
        # exp, sums (csrc/local_soft_argmin.cu)
        "local_soft_argmin": (npix * (D + S + 1) * 4, 20 * npix * S,
                              lambda: ops.local_soft_argmin(vol, cands),
                              lambda: ops.local_soft_argmin_plain(vol, cands),
                              200, 20),
    }
    rows, call_ms = [], {}
    for name, (nbytes, nops, kern, plain, reps, plain_reps) in work.items():
        ms = device_ms(kern, reps, match=name)
        call_ms[name] = time_ms(kern, reps)
        plain_ms = device_ms(plain, plain_reps)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS_PER_S * 1e3
        route, source, replaces = KERNELS[name]
        rows.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
        print(f"  {name}: {ms * 1e3:.1f} us on the device (bound "
              f"{max(t_bytes, t_ops) * 1e3:.1f} us, {nbytes / 1e6:.1f} MB), "
              f"{call_ms[name] * 1e3:.1f} us per wrapper call, plain "
              f"{plain_ms * 1e3:.1f} us", flush=True)
    record["kernels"] = rows
    record["wrapper_call_ms"] = call_ms

    # where one forward's device time goes (profiler, informative)
    record["profile"] = profile(forward)

    # 5. card against the CPU port, TF32 off, moderate weights: the conv
    # weights scaled to sqrt(1.25/fan_in) keep the volume's softmax neither
    # flat nor one-hot; he-normal weights make it nearly one-hot, and
    # float32 rounding then grows over the GRU steps
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = seeded_state_dict(model, seed=1)
    for k, v in sd.items():
        if v.dim() == 4:
            sd[k] = v * np.sqrt(1.25 / 2.0)
    small = {}
    for where in ("cpu", "cuda"):
        m = get_model("LowCNN_gru", device=where)
        m.load_state_dict(sd)
        srng = np.random.default_rng(2)
        li = torch.from_numpy(srng.standard_normal((2, 64, 256, 3),
                                                   dtype=np.float32))
        ri = torch.from_numpy(srng.standard_normal((2, 64, 256, 3),
                                                   dtype=np.float32))
        with torch.inference_mode():
            o = m(li.to(where), ri.to(where), iters=ITERS)
        small[where] = (o["disp_low"].cpu(), o["disparities"][-1].cpu())
    print("card vs CPU port at 64x256, 12 iterations, TF32 off:", flush=True)
    parity = {
        # f32 on both, sums in other orders; the last disparity has been
        # through 12 GRU steps
        "disp_low_px": compare("disp_low", small["cuda"][0], small["cpu"][0],
                               1e-3),
        "last_disparity_px": compare("last disparity", small["cuda"][1],
                                     small["cpu"][1], 5e-3),
    }
    record["parity_vs_cpu"] = parity
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


def profile(forward) -> dict:
    """Device time by kernel over one forward (torch.profiler). Reports
    "not measured" when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward()
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
    print(f"  profile of one forward: {wall_ms:.1f} ms wall (profiled), "
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
