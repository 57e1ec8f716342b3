"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library of
its own with a plain C interface, and loaded with ``ctypes``. The libraries
go to ``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, so a later process reuses them. ``build`` compiles
every source that is not built yet in parallel, one ``nvcc`` per source;
``launch`` builds at first use. Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (source, C function, its argument types; the last is the stream)
KERNELS = {
    "corr_band": ("corr_band.cu", "corr_band_forward",
                  (_P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "local_soft_argmin": ("local_soft_argmin.cu", "local_soft_argmin_forward",
                          (_P, _P, _P, _I, _I, _I, _P)),
    "local_soft_argmin_bwd": ("local_soft_argmin_bwd.cu",
                              "local_soft_argmin_backward",
                              (_P, _P, _P, _P, _P, _I, _I, _I, _P)),
    "conv2d_fused": ("conv2d_fused.cu", "conv2d_fused_forward",
                     (_P,) * 10 + (_I,) * 6 + (_P,)),
}

_functions: dict = {}
build_log: dict = {}   # name -> nvcc's output (ptxas registers and spills)


def _library_path(name: str) -> Path:
    src = (CSRC / KERNELS[name][0]).read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed")
    return path


def build(names=None) -> float:
    """Compile the named kernels (default: all) that are not built yet, all
    at once, and return the seconds it took. Raises with nvcc's output if a
    build fails."""
    t0 = time.perf_counter()
    todo = [n for n in (names or KERNELS) if not _library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[n][0])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        build_log[n] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{build_log[n]}")
        else:
            os.replace(tmp, _library_path(n))   # atomic if processes race
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def _function(name: str):
    fn = _functions.get(name)
    if fn is None:
        build([name])
        _, symbol, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(_library_path(name))), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check_inputs(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned float32
    CUDA tensor on one device: what the kernels take."""
    device = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(
                f"{name}: all inputs must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: inputs must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` with ``args`` (ints and data pointers) on the
    current stream of ``device``; raise if the launch is refused."""
    fn = _function(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
