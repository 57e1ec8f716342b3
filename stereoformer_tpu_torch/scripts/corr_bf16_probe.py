"""Where the bf16 correlation volume spends its time, and what its plan
buys: ``csrc/corr_band.cu``'s bf16 form built in variants and timed at
LowCNN's three bf16 shapes.

    python -m stereoformer_tpu_torch.scripts.corr_bf16_probe [--old DIR]
        [VARIANT ...]

Builds ``csrc/corr_band.cu`` into ``build/probe_corr_bf16/`` as it is
("as_is", on the grid ``ops.cost_volume.corr_bf16_plan`` picks) and in
variants: "wN" (the same library, the plan held to N = 1, 2, 4 or 8 warps
a block); "kcK_stS" and "kcK_stS_wN" (a ring of S stages of K channels, K
32, 64 or 128, the grid planned for it); and three whose results are wrong
but whose times show what the work costs: "no_mma" (the MMAs out, the
ldmatrix loads kept), "no_load" (nothing staged: the MMAs and the band on
whatever shared memory holds) and "no_epilogue" (no band and no output:
the MMAs, whose sums nothing reads, go too; staging and ldmatrix only).
With ``--old DIR``, a directory that holds an earlier ``corr_band.cu`` and
its headers (the parent commit's ``csrc/``, unpacked by ``git archive``),
also that source's bf16 entry as "old". For each: ptxas's registers and
spills of the bf16 entries; the volume against the plain version at one
edge shape ([1,3,67,72], D = 50: a C that ends in half a k16 step, W that
no tile divides), as ``chip_smoke.py`` holds it (one bf16 ulp, or near 0
within 2^-20 of the largest output: the worst output's share of its
tolerance, > 1 wrong); and the device time of one call by CUDA-graph
replay at LowCNN's eval shape [8,72,120,256] with D = 24 and 96 and its
train shape [4,40,80,256] with D = 24, each with the plan it ran, after a
row of the bounds (bytes at 3.35 TB/s, each input read once and the volume
written once). One JSON line per variant, after the card's name. The
default variants: ``DEFAULT``. Needs the card and nvcc; about a minute.
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

from .. import kernels, ops
from ..ops import cost_volume
from .dw_bf16_probe import graph_ms

OUT = kernels.BUILD_DIR.parent / "probe_corr_bf16"
SOURCES = ("corr_band.cu", "bf16mma.cuh")
_MMA = ("        bf16mma::mma_bf16(acc[j], a, b[0], b[1]);\n"
        "        if (j + 1 < NT) bf16mma::mma_bf16(acc[j + 1], a, b[2], "
        "b[3]);\n")
_LOAD = ("      cp_async16(st + (is_l ? 0 : tw * KC) + slot(rr, q),\n"
         "                 ok ? base + (long long)w * C + c : base, ok ? 16 "
         ": 0);\n")
_STAGES = "constexpr int stages(int nt) { return nt <= 8 ? 3 : 2; }"
_KC = "constexpr int KC = 64;           // channels a stage: 128-byte rows"


def _ring(kc: int, stages: int) -> list:
    """The edits that give the ring ``stages`` stages of ``kc`` channels."""
    return [(_KC, _KC.replace("64", str(kc))),
            (_STAGES, _STAGES.replace("nt <= 8 ? 3 : 2", str(stages)))]


# variants that take a part of the work out: their edits
CUTS = {"no_mma": [(_MMA, "")], "no_load": [(_LOAD, "")],
        "no_epilogue": [("      epilogue(s / nk, ls + warp * 16 * spad);\n",
                         "")]}
DEFAULT = ["as_is", "w1", "w2", "w4", "w8", "kc32_st6", "kc64_st2",
           "kc64_st3", "kc128_st2", *CUTS]


def variant(name: str) -> tuple:
    """(source key, edits, ring, warps) of a variant: "as_is", "wN" (N
    warps a block), "kcK_stS" and "kcK_stS_wN" (a ring of S stages of K
    channels), or one of CUTS on the source as it is."""
    if name in CUTS:
        return name, CUTS[name], None, None
    m = re.fullmatch(r"(?:kc(\d+)_st(\d+))?_?(?:w(\d))?", name)
    if name != "as_is" and not (m and name):
        raise SystemExit(f"unknown variant {name}")
    ring = (int(m.group(1)), int(m.group(2))) if m and m.group(1) else None
    warps = int(m.group(3)) if m and m.group(3) else None
    key = f"kc{ring[0]}_st{ring[1]}" if ring else "as_is"
    return key, _ring(*ring) if ring else [], ring, warps


SHAPES = {"eval D=24": ((8, 72, 120, 256), 24),
          "train D=24": ((4, 40, 80, 256), 24),
          "eval D=96": ((8, 72, 120, 256), 96)}
CHECK = ((1, 3, 67, 72), 50)
HBM_BYTES_PER_S = 3.35e12


def build_variants(names, old_dir) -> dict:
    """Compile each source the named variants need, all at once; ->
    {source key: (library, ptxas usage of its bf16 entries)}."""
    sources = {"old": []} if "old" in names else {}
    for name in names:
        if name != "old":
            key, edits, _, _ = variant(name)
            sources[key] = edits
    procs = {}
    for key, edits in sources.items():
        if key == "old" and old_dir is None:
            raise SystemExit("old needs --old DIR")
        d = OUT / key
        d.mkdir(parents=True, exist_ok=True)
        root = Path(old_dir) if key == "old" else kernels.CSRC
        src = {f: (root / f).read_text() for f in SOURCES}
        for text, new in edits:
            if src["corr_band.cu"].count(text) != 1:
                raise RuntimeError(f"{key}: corr_band.cu does not hold "
                                   f"{text!r} once")
            src["corr_band.cu"] = src["corr_band.cu"].replace(text, new)
        for f, text in src.items():
            (d / f).write_text(text)
        lib = d / "corr_band.so"
        procs[key] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
             str(d / "corr_band.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{key} did not build:\n{log}")
        usage = {e: u for e, u in kernels.parse_ptxas(log).items()
                 if "bf" in e}
        out[key] = (lib, usage)
    return out


def _caller(lib, old: bool, ring: tuple, warps, sms):
    fn = ctypes.CDLL(str(lib)).corr_band_forward_bf16
    argtypes = list(kernels.KERNELS["corr_band_bf16"][2])
    fn.argtypes = argtypes[:8] + argtypes[-1:] if old else argtypes
    fn.restype = ctypes.c_int

    def call(left, right, D):
        B, H, W, C = left.shape
        out = left.new_empty((B, H, W, D))
        args = [left.data_ptr(), right.data_ptr(), out.data_ptr(), B, H, W,
                C, D]
        if not old:
            plan = cost_volume.corr_bf16_plan(B, H, W, C, D, sms, warps,
                                              ring)
            args += [plan["warps"], plan["span"], plan["blocks"]]
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return out
    return call


def _inputs(rng, shape):
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().bfloat16() for _ in range(2))


def _check(call, rng) -> float:
    """The worst output's share of its tolerance at CHECK (> 1: wrong)."""
    shape, D = CHECK
    left, right = _inputs(rng, shape)
    got = call(left, right, D).double()
    want = ops.correlation_volume_plain(left, right, D).double()
    big = torch.maximum(got.abs(), want.abs()).clamp(min=1e-30)
    tol = (2.0 ** -7 * torch.exp2(torch.floor(torch.log2(big)))).clamp(
        min=2.0 ** -20 * want.abs().max().item())
    share = ((got - want).abs() / tol).max().item()
    return share if np.isfinite(share) else float("inf")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--old", help="a directory with an earlier corr_band.cu "
                   "and its headers, probed as old")
    p.add_argument("variants", nargs="*")
    opt = p.parse_args(argv)
    names = opt.variants or (DEFAULT + (["old"] if opt.old else []))
    print(torch.cuda.get_device_name(0), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = build_variants(names, opt.old)
    rng = np.random.default_rng(0)
    inputs = {where: _inputs(rng, shape)
              for where, (shape, _) in SHAPES.items()}
    row = {"variant": "bound_bytes"}
    for where, (shape, D) in SHAPES.items():
        npix = int(np.prod(shape[:3]))
        row[where] = (2 * npix * shape[3] + npix * D) * 2 / HBM_BYTES_PER_S \
            * 1e3
    print(json.dumps(row), flush=True)
    for name in names:
        old = name == "old"
        key, _, ring, warps = ("old", [], None, None) if old else variant(
            name)
        lib, usage = libs[key]
        call = _caller(lib, old, ring, warps, sms)
        row = {"variant": name, "ptxas": usage,
               "worst_share_of_tolerance": _check(
                   call, np.random.default_rng(1))}
        for where, (shape, D) in SHAPES.items():
            left, right = inputs[where]
            if not old:
                plan = cost_volume.corr_bf16_plan(*shape, D, sms, warps,
                                                  ring)
                row[f"{where} plan"] = {k: plan[k] for k in (
                    "warps", "nt", "tasks", "per_sm", "blocks")}
            row[where] = graph_ms(lambda: call(left, right, D), 50)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
