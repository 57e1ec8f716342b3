"""Where the 3xTF32 conv kernels spend their time: each timed with a part of
its work taken out.

    python -m stereoformer_tpu_torch.scripts.tf32x3_probe

Builds ``csrc/conv2d_dw.cu`` and ``csrc/conv2d_s2.cu`` (with
``csrc/tf32x3.cuh``) into ``build/probe/`` as they are ("full") and in three
variants whose results are wrong but whose times show what the work costs:
"one_pass" runs only the big*big MMA (a third of the MMAs), "no_split"
passes the float32 operands unsplit (no rounding, no subtract), and
"no_staging" copies only the first tile (or channel chunk) from device
memory and computes every later one on it. Times each by CUDA events over
20 calls at RAFT's largest conv2d_dw sites and two of its stride-2 sites,
and prints one line per kernel, site and variant. Needs the card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

from .. import kernels
from ..ops.dw_conv import dw_plan

OUT = kernels.BUILD_DIR.parent / "probe"
# variant -> (file, text, replacement); each text must occur in the file
VARIANTS = {
    "full": [],
    "one_pass": [
        ("tf32x3.cuh",
         "for (int j = 0; j < N; ++j) mma_tf32(d[i][j], a[i].small, b[j].big);",
         "for (int j = 0; j < N; ++j) {}"),
        ("tf32x3.cuh",
         "for (int j = 0; j < N; ++j) mma_tf32(d[i][j], a[i].big, b[j].small);",
         "for (int j = 0; j < N; ++j) {}")],
    "no_split": [
        ("tf32x3.cuh",
         "big = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;\n"
         "  small = __float_as_uint(a - __uint_as_float(big));",
         "big = small = __float_as_uint(a);")],
    "no_staging": [
        ("conv2d_dw.cu", "if (tile + 1 < t_end) {", "if (false) {"),
        ("conv2d_s2.cu", "if (c0 + KC < C) {", "if (false) {")],
}
DW_SITES = [(8, 320, 720, 64), (8, 160, 360, 96)]
S2_SITES = [(4, 576, 960, 64, 96), (2, 72, 120, 128, 128)]


def build_variants() -> dict:
    """Compile every variant of both kernels at once; -> {(variant, kernel):
    library path}."""
    procs = {}
    for variant, edits in VARIANTS.items():
        d = OUT / variant
        d.mkdir(parents=True, exist_ok=True)
        sources = {f: (kernels.CSRC / f).read_text()
                   for f in ("tf32x3.cuh", "conv2d_dw.cu", "conv2d_s2.cu")}
        for f, text, new in edits:
            if text not in sources[f]:
                raise RuntimeError(f"{variant}: {f} no longer holds {text!r}")
            sources[f] = sources[f].replace(text, new)
        for f, src in sources.items():
            (d / f).write_text(src)
        for k in ("conv2d_dw", "conv2d_s2"):
            lib = d / f"{k}.so"
            procs[variant, k] = (lib, subprocess.Popen(
                [kernels._nvcc(), *kernels.nvcc_flags(f"{k}.cu"), "-o",
                 str(lib), str(d / f"{k}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{key} did not build:\n{log}")
        libs[key] = lib
    return libs


def time_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of a kernel's C entry ``fn`` (which returns its
    cudaError); raises if the first launch is refused."""
    err = fn()
    if err:
        raise RuntimeError(f"launch failed with cudaError {err}")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _entry(lib: Path, name: str):
    _, symbol, argtypes = kernels.KERNELS[name]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(torch.cuda.get_device_name(dev), flush=True)
    for B, H, W, C in DW_SITES:
        x = torch.randn(B, H, W, C, device=dev, generator=gen)
        g = torch.randn(B, H, W, C, device=dev, generator=gen)
        nsplit, _ = dw_plan(C, sms)
        part = x.new_empty((nsplit, 9, C, C))
        dw = x.new_empty((3, 3, C, C))
        args = (x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                B, H, W, C, C, nsplit, stream)
        for variant in VARIANTS:
            fn = _entry(libs[variant, "conv2d_dw"], "conv2d_dw")
            print(f"conv2d_dw {[B, H, W, C]} {variant}: "
                  f"{time_ms(lambda: fn(*args)):.4f} ms", flush=True)
    for B, H, W, C, Co in S2_SITES:
        x = torch.randn(B, H, W, C, device=dev, generator=gen)
        w = torch.randn(3, 3, C, Co, device=dev, generator=gen)
        b = torch.randn(Co, device=dev, generator=gen)
        y = x.new_empty((B, H // 2, W // 2, Co))
        args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, H,
                W, C, Co, 0, stream)
        for variant in VARIANTS:
            fn = _entry(libs[variant, "conv2d_s2"], "conv2d_s2")
            print(f"conv2d_s2 {[B, H, W, C, Co]} {variant}: "
                  f"{time_ms(lambda: fn(*args)):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
