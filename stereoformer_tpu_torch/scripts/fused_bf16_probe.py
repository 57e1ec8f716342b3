"""Where the bf16 fused conv spends its time, and what its tile and pipeline
constants buy: the kernel built in variants and timed at RAFT's four eval
sites.

    python -m stereoformer_tpu_torch.scripts.fused_bf16_probe [VARIANT ...]

Builds ``csrc/conv2d_fused.cu`` into ``build/probe_bf16/`` as it is
("as_is") and in variants made by replacing its constants or taking a part
of its work out (``VARIANTS``): other rows per warp (``bfk::RW``), chunk
depths (``Cfg::KC``) and ring depths (``Cfg::STAGES``), the window's
copies with an L2 line fetch, and some whose results are wrong but whose
times show what the work costs: "no_mma" (the MMAs out, the ldmatrix
loads kept), "no_compute" (no tap is read: staging, prologue and epilogue
only), and "no_compute" without the window's reads from device memory
(zero-filled) or without the stores of y. For each variant: ptxas's
registers and spills of the bf16 entries; y and the moments against the
plain version (``ops.conv3x3_plain``) at [2,19,40,72->96] and
[1,37,53,96->64], as ``chip_smoke.py`` holds them (one bf16 ulp, moments
within 1e-5 beyond what the outputs that round differently move them by;
the worst output's share of its tolerance, inf for a moment beyond its
own); and the device time of one call by CUDA-graph replay at RAFT's four
eval sites (B=2, 576x960, ``chip_smoke.py::RAFT_CONVS``: the feature net's
prologue+stats, the context net's prologue), beside cuDNN's bf16
``F.conv2d`` with bias on the same inputs. One JSON line per variant, after
the card's name. Needs the card and nvcc; about a minute.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels, ops
from ..ops.fused_conv import fused_tiles

OUT = kernels.BUILD_DIR.parent / "probe_bf16"
SOURCES = ("conv2d_fused.cu", "tf32x3.cuh", "bf16mma.cuh")
_RW = "constexpr int RW = 2;               // output rows per warp"
_KC = "static constexpr int KC = NB == 48 ? 32 : 16;"
_ST = "static constexpr int STAGES = NB == 64 ? 3 : NB == 48 ? 2 : 4;"
_WINDOW_COPY = "tf32x3::cp_async16(dst + bfk::xunit<UP>(p, q)"
_NO_COMPUTE = ("#pragma unroll\n    for (int tap = 0; tap < 9; ++tap) {\n"
               "      const int ky = tap / 3, kx = tap % 3;\n"
               "#pragma unroll\n      for (int ks",
               "#pragma unroll\n    for (int tap = 0; tap < 0; ++tap) {\n"
               "      const int ky = tap / 3, kx = tap % 3;\n"
               "#pragma unroll\n      for (int ks")


# variant -> edits of conv2d_fused.cu (each text must occur in it)
VARIANTS = {
    "as_is": [],
    # 4 x 32-pixel tiles: the weights staged twice as often
    "rw1": [(_RW, "constexpr int RW = 1;")],
    # other chunk and ring depths: 2 x 16 channels at NB = 64; 16 channels
    # at NB = 48; 32 at both (NB = 64 then fits one block an SM)
    "nb64_st2": [(_ST, "static constexpr int STAGES = 2;")],
    "kc16": [(_KC, "static constexpr int KC = 16;")],
    "kc32": [(_KC, "static constexpr int KC = 32;")],
    # the window's copies have L2 fetch the source's whole 128-byte line
    "prefetch": [
        ("}  // namespace bfk",
         "__device__ __forceinline__ void cp_async16_pf(void* dst, "
         "const void* src, int n) {\n  asm volatile(\"cp.async.cg.shared."
         "global.L2::128B [%0], [%1], 16, %2;\\n\" ::\"r\"(smem_addr(dst))"
         ", \"l\"(src), \"r\"(n));\n}\n\n}  // namespace bfk"),
        (_WINDOW_COPY, "bfk::cp_async16_pf(dst + bfk::xunit<UP>(p, q)")],
    "no_mma": [("            bfk::mma_bf16(acc[h][2 * jp], a[h], bq[0], "
                "bq[1]);\n            bfk::mma_bf16(acc[h][2 * jp + 1], "
                "a[h], bq[2], bq[3]);", "")],
    "no_compute": [_NO_COMPUTE],
    # no_compute, and the window not read from device memory
    "no_compute_no_window": [
        _NO_COMPUTE,
        ("      const bool in = off >= 0 && c < C;\n      " + _WINDOW_COPY,
         "      const bool in = false;\n      " + _WINDOW_COPY)],
    # no_compute, and y not stored
    "no_compute_no_store": [
        _NO_COMPUTE,
        ("    if (oy >= H || ox >= W) continue;\n"
         "    *reinterpret_cast<uint4*>(y",
         "    if (true) continue;\n    *reinterpret_cast<uint4*>(y")],
}
# RAFT eval at B=2, 576x960 (chip_smoke.py::RAFT_CONVS): B, H, W, C = Co
SITES = {"fnet layer1": (4, 576, 960, 64), "cnet layer1": (2, 576, 960, 64),
         "fnet layer2": (4, 288, 480, 96), "cnet layer2": (2, 288, 480, 96)}
CHECKS = [(2, 19, 40, 72, 96), (1, 37, 53, 96, 64)]


def build_variants(names) -> dict:
    """Compile the named variants at once; -> {variant: (library, ptxas
    usage of its bf16 entries)}."""
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        src = {f: (kernels.CSRC / f).read_text() for f in SOURCES}
        for text, new in VARIANTS[name]:
            if text not in src["conv2d_fused.cu"]:
                raise RuntimeError(f"{name}: conv2d_fused.cu no longer holds "
                                   f"{text!r}")
            src["conv2d_fused.cu"] = src["conv2d_fused.cu"].replace(text, new)
        for f, text in src.items():
            (d / f).write_text(text)
        lib = d / "conv2d_fused.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.nvcc_flags("conv2d_fused.cu"), "-o",
             str(lib), str(d / "conv2d_fused.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
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
        out[name] = (lib, usage)
    return out


def _caller(lib):
    fn = ctypes.CDLL(str(lib)).conv2d_fused_forward_bf16
    fn.argtypes = list(kernels.KERNELS["conv2d_fused_bf16"][2])
    fn.restype = ctypes.c_int

    def call(x, w, b, s, t, stats):
        B, H, W, C = x.shape
        Co = w.shape[3]
        y = x.new_empty((B, H, W, Co))
        f32 = dict(dtype=torch.float32)
        # scratch for 4-row tiles, enough for any variant's
        part = x.new_empty((B, fused_tiles(H, W), 2, Co), **f32)
        s1, s2 = x.new_empty((B, Co), **f32), x.new_empty((B, Co), **f32)
        ptr = (lambda a: None if a is None else a.data_ptr())
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), ptr(s), ptr(t),
                 None, y.data_ptr(), ptr(part if stats else None),
                 ptr(s1 if stats else None), ptr(s2 if stats else None),
                 B, H, W, C, Co, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return (y, s1, s2) if stats else y
    return call


def _inputs(rng, B, H, W, C, Co):
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
    x = randn(B, H, W, C).bfloat16()
    w = (randn(3, 3, C, Co) / np.sqrt(9 * C)).bfloat16()
    b = (0.1 * randn(Co)).bfloat16()
    s = torch.from_numpy(rng.uniform(0.5, 1.5, (B, C)).astype(
        np.float32)).cuda()
    return x, w, b, s, 0.5 * randn(B, C)


def _check(call, rng) -> float:
    """The worst output's share of its tolerance (> 1: wrong) over CHECKS,
    prologue+stats; inf where a moment is beyond its tolerance."""
    worst = 0.0
    for shape in CHECKS:
        x, w, b, s, t = _inputs(rng, *shape)
        got = call(x, w, b, s, t, True)
        want = ops.conv3x3_plain(x, w, b, s=s, t=t, with_stats=True)
        torch.cuda.synchronize()
        g, m = got[0].float(), want[0].float()
        big = torch.maximum(g.abs(), m.abs()).clamp(min=1e-30)
        tol = (2.0 ** -7 * torch.exp2(torch.floor(torch.log2(big)))).clamp(
            min=2.0 ** -20 * m.abs().max().item())
        worst = max(worst, ((g - m).abs() / tol).max().item())
        yg, yw = got[0].double(), want[0].double()
        slack = ((yg - yw).abs().sum((1, 2)),
                 (yg ** 2 - yw ** 2).abs().sum((1, 2)))
        for gm, wm, sl in zip(got[1:], want[1:], slack):
            wm = wm.double()
            tol_m = 1e-5 * (wm.abs() + wm.abs().max()) + sl
            if not bool(((gm.double() - wm).abs() <= tol_m).all()):
                worst = float("inf")
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
    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    print(torch.cuda.get_device_name(0), flush=True)
    libs = build_variants(names)
    rng = np.random.default_rng(0)
    inputs = {where: _inputs(rng, B, H, W, C, C)
              for where, (B, H, W, C) in SITES.items()}
    row = {"variant": "cudnn"}
    for where, (x, w, b, s, t) in inputs.items():
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        row[where] = graph_ms(lambda: F.conv2d(xc, wc, b, padding=1))
    print(json.dumps(row), flush=True)
    for name in names:
        lib, usage = libs[name]
        call = _caller(lib)
        row = {"variant": name, "ptxas": usage,
               "worst_share_of_tolerance": _check(
                   call, np.random.default_rng(1))}
        for where, (x, w, b, s, t) in inputs.items():
            stats = where.startswith("fnet")
            row[where] = graph_ms(lambda: call(x, w, b, s, t, stats))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
