"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library of
its own with a plain C interface, and loaded with ``ctypes``; a source may
hold several kernels (a float32 and a bf16 form), each its own C entry. The
libraries go to ``build/kernels/`` at the root of the checkout, named by a
hash of the source, the headers in ``csrc/`` and the flags, so a later
process reuses them; ptxas's report (registers, spills) is kept beside each
library.
``build`` compiles every source that is not built yet in parallel, one
``nvcc`` per source; ``launch`` builds at first use. Nothing is built or
loaded at import.

Every kernel entry that a model's forward or backward reaches is a
``torch.library`` custom op in the ``stereoformer`` namespace (``OPS``),
registered by the op module that launches it (``ops/cost_volume.py``,
``ops/local_volume.py``, ``ops/fused_conv.py``, ``ops/dw_conv.py``,
``ops/deform.py``): its CUDA implementation is the launch, its CPU
implementation the plain version, and a fake implementation gives the
outputs' shapes, so that ``torch.export`` keeps each op as one node that an
artifact calls by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
# the bf16 weight gradient's tiling by Co (csrc/conv2d_dw.cu, bfd::Cfg):
# input channels a block (KC), n8 tiles of outputs a warp (WN8), strip width
# (TW), ring depth in stages (STAGES), resident blocks an SM (MINB), and
# warpgroup MMAs or warp MMAs (WG 1 or 0). The source is built with it as
# -D defines (``tiling_defines``), and ops/dw_conv.py plans its grid by it.
DW_BF16_TILING = {
    64: {"KC": 64, "WN8": 8, "TW": 16, "STAGES": 6, "MINB": 1, "WG": 1},
    96: {"KC": 32, "WN8": 3, "TW": 32, "STAGES": 3, "MINB": 1, "WG": 0},
    128: {"KC": 32, "WN8": 4, "TW": 16, "STAGES": 4, "MINB": 1, "WG": 0},
}
# the bf16 fused conv's widest C whose sums a block keeps unfolded
# (csrc/conv2d_fused.cu, built with -DBF16_FOLD_C); past it a block takes 32
# output channels and folds each chunk's sums into float32 totals, and
# ops/fused_conv.py plans its grid by it
BF16_FOLD_C = 96


def tiling_defines(tiling: dict) -> tuple:
    """The -D flags that give csrc/conv2d_dw.cu the bf16 tiling ``tiling``
    (DW64_KC=64, ..)."""
    return tuple(f"-DDW{C}_{k}={v}" for C, t in tiling.items()
                 for k, v in t.items())


def nvcc_flags(source: str) -> tuple:
    """nvcc's flags for ``source``: NVCC_FLAGS and the source's defines."""
    if source == "conv2d_dw.cu":
        return NVCC_FLAGS + tiling_defines(DW_BF16_TILING)
    if source == "conv2d_fused.cu":
        return NVCC_FLAGS + (f"-DBF16_FOLD_C={BF16_FOLD_C}",)
    return NVCC_FLAGS


# the torch.library namespace of the kernels' custom ops
OPS = "stereoformer"

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (source, C function, its argument types; the last is the stream)
KERNELS = {
    "corr_band": ("corr_band.cu", "corr_band_forward",
                  (_P, _P, _P, _I, _I, _I, _I, _I, _P)),
    "corr_band_bf16": ("corr_band.cu", "corr_band_forward_bf16",
                       (_P, _P, _P) + (_I,) * 8 + (_P,)),
    "local_soft_argmin": ("local_soft_argmin.cu", "local_soft_argmin_forward",
                          (_P, _P, _P, _I, _I, _I, _P)),
    "local_soft_argmin_bwd": ("local_soft_argmin_bwd.cu",
                              "local_soft_argmin_backward",
                              (_P, _P, _P, _P, _P, _I, _I, _I, _P)),
    "conv2d_fused": ("conv2d_fused.cu", "conv2d_fused_forward",
                     (_P,) * 10 + (_I,) * 6 + (_P,)),
    "conv2d_fused_bf16": ("conv2d_fused.cu", "conv2d_fused_forward_bf16",
                          (_P,) * 10 + (_I,) * 6 + (_P,)),
    "conv2d_dw": ("conv2d_dw.cu", "conv2d_dw", (_P,) * 4 + (_I,) * 6 + (_P,)),
    "conv2d_dw_bf16": ("conv2d_dw.cu", "conv2d_dw_bf16",
                       (_P,) * 4 + (_I,) * 6 + (_P,)),
    "deform_sample": ("deform_sample.cu", "deform_sample_forward",
                      (_P,) * 5 + (_I,) * 9 + (_P, _P)),
    "conv2d_s2": ("conv2d_s2.cu", "conv2d_s2_forward",
                  (_P,) * 4 + (_I,) * 6 + (_P,)),
    "row_gather": ("row_gather.cu", "row_gather_forward",
                   (_P,) * 3 + (_I,) * 3 + (_P,)),
}

# the dtype of the tensors each kernel takes; a kernel's other operands (the
# bf16 fused conv's prologue s and t) are checked against their own dtype
DTYPES = {name: torch.bfloat16 if name.endswith("_bf16") else torch.float32
          for name in KERNELS}

_functions: dict = {}
build_log: dict = {}   # source -> nvcc's output (ptxas registers and spills)


def _library_path(name: str) -> Path:
    """The library of kernel ``name``, named by its source, a hash of it,
    every header in ``csrc/`` (a source may include any of them) and the
    flags: the kernels of one source share it."""
    source = KERNELS[name][0]
    digest = hashlib.sha1((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(nvcc_flags(source)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:12]}.so"


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
    todo = {}   # one name per source
    for n in names or KERNELS:
        if not _library_path(n).exists():
            todo.setdefault(KERNELS[n][0], n)
    todo = list(todo.values())
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _library_path(n).with_suffix(f".{os.getpid()}.tmp")
        source = KERNELS[n][0]
        cmd = [nvcc, *nvcc_flags(source), "-o", str(tmp), str(CSRC / source)]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log = build_log[KERNELS[n][0]] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{KERNELS[n][0]} (nvcc exit {proc.returncode}):"
                          f"\n{log}")
        else:
            _library_path(n).with_suffix(".log").write_text(log)
            os.replace(tmp, _library_path(n))   # atomic if processes race
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


# the builtin types of the Itanium mangling that template arguments take
_MANGLED_TYPES = {"f": "float", "d": "double", "i": "int", "b": "bool"}


def _entry_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol:
    ``dw_kernel<96>``, ``conv3x3_s2_kernel<4,1>``,
    ``corr_band_bf16_kernel<5>``, ``conv3x3_bf16_kernel<64>``,
    ``dw_bf16_kernel<96>``."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = mangled
    while (m := re.match(r"\d+", rest)):
        n = int(m.group())
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    if rest.startswith("I"):
        args = re.findall(r"L[a-z](\d+)E|(\d+)([A-Za-z_]\w*)|([a-z])",
                          rest[1:rest.find("EE") + 1])
        name += "<" + ",".join(
            lit or (ident[:int(n)] if n else _MANGLED_TYPES.get(b, b))
            for lit, n, ident, b in args) + ">"
    return name


def ptxas_usage(name: str) -> dict:
    """Registers and spill bytes of each entry function of kernel ``name``'s
    source, as ptxas reported them when its library was built
    (``build_log``, or the log kept beside the library; empty if neither
    exists): entry -> {"registers", "spill_stores", "spill_loads"}."""
    log = build_log.get(KERNELS[name][0])
    if log is None and _library_path(name).with_suffix(".log").exists():
        log = _library_path(name).with_suffix(".log").read_text()
    return parse_ptxas(log or "")


def parse_ptxas(log: str) -> dict:
    """Registers and spill bytes of each entry function in nvcc's output
    with ``-Xptxas -v``: entry -> {"registers", "spill_stores",
    "spill_loads"}."""
    usage, entry = {}, None
    for line in log.splitlines():
        if (m := re.search(r"Compiling entry function '(\w+)'", line)):
            entry = _entry_name(m.group(1))
            usage[entry] = {}
        elif entry and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[entry].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            usage[entry]["registers"] = int(m.group(1))
    return usage


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


def check_inputs(name: str, *tensors: torch.Tensor, dtype=None) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor on one device, of the dtype kernel ``name`` takes (``DTYPES``;
    ``dtype`` for operands of another): what the kernels take. The error
    names the kernel."""
    device = tensors[0].device
    want = dtype or DTYPES[name]
    for t in tensors:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(
                f"{name}: all inputs must lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
        if t.dtype != want:
            raise TypeError(f"{name}: the kernel takes {want} inputs, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def plain_vjp(fn, tensors, grad, needs, *args) -> tuple:
    """The gradient of ``fn(*tensors, *args)`` by autograd, recomputed from
    detached copies of ``tensors`` (None for a tensor that is None or that
    ``needs`` does not ask for): an op's gradient where it is autograd of
    its plain version."""
    want = [t is not None and n for t, n in zip(tensors, needs)]
    leaves = [t.detach().requires_grad_(w) if t is not None else None
              for t, w in zip(tensors, want)]
    with torch.enable_grad():
        out = fn(*leaves, *args)
    wrt = [t for t, w in zip(leaves, want) if w]
    got = iter(torch.autograd.grad(out, wrt, grad) if wrt else ())
    return tuple(next(got) if w else None for w in want)


def launch(name: str, device: torch.device, *args) -> None:
    """Launch kernel ``name`` with ``args`` (ints and data pointers) on the
    current stream of ``device``; raise if the launch is refused."""
    fn = _function(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
