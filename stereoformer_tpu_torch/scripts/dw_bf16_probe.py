"""Where the bf16 weight gradient spends its time, and what its tiling buys:
``csrc/conv2d_dw.cu``'s bf16 form built in variants and timed at RAFT's
four train sites.

    python -m stereoformer_tpu_torch.scripts.dw_bf16_probe [--old DIR]
        [VARIANT ...]

Builds ``csrc/conv2d_dw.cu`` into ``build/probe_dw_bf16/`` as it is
("as_is") and in variants made by changing its tiling (``TILINGS``, over
``kernels.DW_BF16_TILING``) or taking a part of its work out
(``VARIANTS``): "no_mma" (the MMAs out, the
ldmatrix loads kept), "no_compute" (no stage is read: staging, folds and
the reduction only), "no_load" (no stage is staged or waited for: the
mainloops, folds and the reduction on whatever the ring holds); "mma64"
(Co = 64 on the warp MMAs, 32-channel slices, two blocks an SM) and
"mma64_no_load"; "wg_sync" (each stage's warpgroup MMAs waited for before
the stage ends, thread 0 a stage further ahead); "swap_desc" (the wgmma
descriptor's two strides swapped: wrong, the check shows it); "st_less"
(a shallower ring). With ``--old DIR``, a directory that holds an earlier
``conv2d_dw.cu`` and its headers (the parent commit's ``csrc/``, unpacked
by ``git archive``), also that source as "old", "old_no_mma" and
"old_no_compute", on the float32 form's grid (``dw_plan(C, sms)``), as that
bf16 form took it. Each variant runs on the grid its own tiling fills in
whole waves (``ops.dw_conv.whole_waves``). For each: ptxas's registers and
spills of the bf16 entries; dw against the plain version in float64 at one
edge shape a template ([1,37,53,96] and [2,19,40,64]), as ``chip_smoke.py``
holds it (one bf16 ulp, or near 0 within ``DW_BF16_RTOL`` of the largest
|dw|: the worst output's share of its tolerance, > 1 wrong); and the device
time of one call by CUDA-graph replay at RAFT's four train sites (B=4,
320x720, ``chip_smoke.py::RAFT_TRAIN_CONVS``), beside cuDNN's bf16
``conv2d_weight`` on the same inputs, and the sum over the 14 launches of
a RAFT bf16 train step ("sum_14"). One JSON line per variant, after the
card's name. Needs the card and nvcc; about a minute and a half.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.nn.grad import conv2d_weight

from .. import kernels, ops
from ..ops.dw_conv import dw_plan, whole_waves

OUT = kernels.BUILD_DIR.parent / "probe_dw_bf16"
SOURCES = ("conv2d_dw.cu", "tf32x3.cuh", "bf16mma.cuh")
_MMA = ("            bf16mma::mma_bf16(acc[3 * di + dj][j], a,\n"
        "                              bc[sg][(k + 2 - di) % 3][j][0],\n"
        "                              bc[sg][(k + 2 - di) % 3][j][1]);")
_WGMMA = ("        wgmma_64x64(acc[di], a[k], gdesc(g, S::GREG, 8 * LINE));")
_NO_STEPS = [
    ("      mainloop_wgmma<CO>(acc, awg, xs, xprev, f, al);", "      ;"),
    ("      mainloop_mma<CO>(acc, bc, xs, f, al, bbox, boff);", "      ;")]
_NO_LOAD = [
    ("    mbar_expect_tx(bar, S::TX);\n"
     "    for (int i = 0; i < S::NXR; ++i)\n"
     "      tma_load(dst + i * S::XREG, xm, bar, c0 + 32 * i, x0 - 1, r, b);\n"
     "    for (int i = 0; i < S::NGR; ++i)\n"
     "      tma_load(dst + S::GOFF + i * S::GREG, gm, bar, 32 * i, x0, r + 1, "
     "b);\n", ""),
    ("    mbar_wait(full + slot, (t / S::STAGES) & 1);   // stage t has "
     "landed\n", "")]


# Co = 64 on the warp MMAs (32-channel slices, 4 warps, 2 blocks an SM)
_MMA64 = {64: {"KC": 32, "WN8": 4, "STAGES": 3, "MINB": 2, "WG": 0}}
# variant -> its tiling's changes from kernels.DW_BF16_TILING, by C
TILINGS = {
    "mma64": _MMA64,
    "mma64_no_load": _MMA64,
    # ring depth
    "st_less": {64: {"STAGES": 5}, 96: {"STAGES": 2}},
}
# variant -> edits of the current conv2d_dw.cu (each text must occur once)
VARIANTS = {
    "as_is": [],
    "no_mma": [(_MMA, "              ;"), (_WGMMA, "        ;")],
    "no_compute": _NO_STEPS,
    "no_load": _NO_LOAD,
    "mma64": [],
    "mma64_no_load": _NO_LOAD,
    # the wgmma descriptor's two strides the other way round
    "swap_desc": [(_WGMMA, _WGMMA.replace("S::GREG, 8 * LINE",
                                          "8 * LINE, S::GREG"))],
    # each stage's warpgroup MMAs waited for before the stage ends (not
    # while the next is waited for), thread 0 one stage further ahead
    "wg_sync": [
        ("  wgmma_wait0();\n  // the lane's lines carry dj (ALane)\n",
         "  // the lane's lines carry dj (ALane)\n"),
        (_WGMMA + "\n    }\n  wgmma_commit();\n}",
         _WGMMA + "\n    }\n  wgmma_commit();\n  wgmma_wait0();\n}"),
        ("S::STAGES - 1 - 2 * S::WG", "S::STAGES - 1 - S::WG")],
    "st_less": [],
}
# edits of the earlier source (the form before the nine-tap walk): its
# MMAs, and its k-step loop
OLD_VARIANTS = {
    "old": [],
    "old_no_mma": [
        ("          bf16mma::mma_bf16(acc[i][2 * jp], a[i], bq[jp][0], "
         "bq[jp][1]);\n          bf16mma::mma_bf16(acc[i][2 * jp + 1], a[i], "
         "bq[jp][2], bq[jp][3]);", "")],
    "old_no_compute": [
        ("    for (int ks = 0; ks < KSTEPS; ++ks) {\n"
         "      const int r = ks / (TW / 16);",
         "    for (int ks = 0; ks < 0; ++ks) {\n"
         "      const int r = ks / (TW / 16);")],
}
# RAFT's train step at B=4, 320x720 (chip_smoke.py::RAFT_TRAIN_CONVS)
SITES = {"fnet layer1": (8, 320, 720, 64), "cnet layer1": (4, 320, 720, 64),
         "fnet layer2": (8, 160, 360, 96), "cnet layer2": (4, 160, 360, 96)}
CHECKS = [(1, 37, 53, 96), (2, 19, 40, 64)]
# chip_smoke.py's DW_BF16_RTOL
DW_BF16_RTOL = 2e-5


def build_variants(names, old_dir) -> dict:
    """Compile the named variants at once; -> {variant: (library, ptxas
    usage of its bf16 entries, {C: nsplit})}."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    procs = {}
    for name in names:
        old = name.startswith("old")
        if old and old_dir is None:
            raise SystemExit(f"{name} needs --old DIR")
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        root = Path(old_dir) if old else kernels.CSRC
        src = {f: (root / f).read_text() for f in SOURCES}
        for text, new in (OLD_VARIANTS if old else VARIANTS)[name]:
            if src["conv2d_dw.cu"].count(text) != 1:
                raise RuntimeError(f"{name}: conv2d_dw.cu does not hold "
                                   f"{text!r} once")
            src["conv2d_dw.cu"] = src["conv2d_dw.cu"].replace(text, new)
        for f, text in src.items():
            (d / f).write_text(text)
        tiling = {C: {**t, **TILINGS.get(name, {}).get(C, {})}
                  for C, t in kernels.DW_BF16_TILING.items()}
        if old:
            plan = {C: dw_plan(C, sms)[0] for C in (64, 96)}
        else:
            plan = {C: whole_waves(sms * t["MINB"], C // t["KC"])[0]
                    for C, t in tiling.items()}
        lib = d / "conv2d_dw.so"
        procs[name] = (lib, plan, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS,
             *kernels.tiling_defines(tiling), "-o", str(lib),
             str(d / "conv2d_dw.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, plan, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name} did not build:\n{log}")
        usage, entry = {}, None
        for line in log.splitlines():
            if (m := re.search(r"Compiling entry function '(\w+)'", line)):
                entry = kernels._entry_name(m.group(1))
            elif entry and "bf16" in entry and (
                    m := re.search(r"Used (\d+) registers", line)):
                usage.setdefault(entry, {})["registers"] = int(m.group(1))
            elif entry and "bf16" in entry and (m := re.search(
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                    line)):
                usage.setdefault(entry, {})["spills"] = (
                    int(m.group(1)) + int(m.group(2)))
        out[name] = (lib, usage, plan)
    return out


def _caller(lib, plan):
    fn = ctypes.CDLL(str(lib)).conv2d_dw_bf16
    fn.argtypes = list(kernels.KERNELS["conv2d_dw_bf16"][2])
    fn.restype = ctypes.c_int

    def call(x, g):
        B, H, W, C = x.shape
        part = x.new_empty((plan[C], 9, C, C), dtype=torch.float32)
        dw = x.new_empty((3, 3, C, C))
        err = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                 B, H, W, C, C, plan[C],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return dw
    return call


def _inputs(rng, shape):
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().bfloat16() for _ in range(2))


def _check(call, rng) -> float:
    """The worst output's share of its tolerance over CHECKS (> 1: wrong)."""
    worst = 0.0
    for shape in CHECKS:
        x, g = _inputs(rng, shape)
        got = call(x, g).double()
        want = ops.conv2d_dw_plain(x.double(), g.double())
        ref = want.to(torch.bfloat16).double()
        big = torch.maximum(got.abs(), ref.abs()).clamp(min=1e-30)
        tol = (2.0 ** -7 * torch.exp2(torch.floor(torch.log2(big)))).clamp(
            min=DW_BF16_RTOL * want.abs().max().item())
        share = ((got - ref).abs() / tol).max().item()
        worst = max(worst, share if np.isfinite(share) else float("inf"))
    return worst


def graph_ms(fn, reps: int = 10, replays: int = 3) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    the graph replayed ``replays`` times after a warm-up, the least mean."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    best = float("inf")
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", help="a directory with an earlier conv2d_dw.cu "
                   "and its headers, probed as old, old_no_mma, "
                   "old_no_compute")
    p.add_argument("variants", nargs="*")
    opt = p.parse_args(argv)
    names = opt.variants or (list(VARIANTS) + (list(OLD_VARIANTS)
                                               if opt.old else []))
    print(torch.cuda.get_device_name(0), flush=True)
    libs = build_variants(names, opt.old)
    rng = np.random.default_rng(0)
    inputs = {where: _inputs(rng, shape) for where, shape in SITES.items()}
    row = {"variant": "cudnn"}
    for where, (x, g) in inputs.items():
        C = x.shape[3]
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        row[where] = graph_ms(
            lambda: conv2d_weight(xc, (C, C, 3, 3), gc, padding=1))
    print(json.dumps(row), flush=True)
    for name in names:
        lib, usage, plan = libs[name]
        call = _caller(lib, plan)
        row = {"variant": name, "ptxas": usage, "nsplit": plan,
               "worst_share_of_tolerance": _check(
                   call, np.random.default_rng(1))}
        for where, (x, g) in inputs.items():
            row[where] = graph_ms(lambda: call(x, g))
        row["sum_14"] = sum(n * row[w] for w, n in zip(SITES, (4, 4, 3, 3)))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
