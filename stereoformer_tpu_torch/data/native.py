"""ctypes binding of the native host IO library
(``native/libstereoformer_io.so`` at the repository root; build it with
``make -C native``).

Counterpart of ``stereoformer_tpu/data/native.py``, binding the same
library. Where it is not built, ``available()`` is false and the callers
take their numpy and PIL paths, which give the same arrays.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libstereoformer_io.so",
)

_lib: Optional[ctypes.CDLL] = None
_warned_fallback = False


def load_library() -> Optional[ctypes.CDLL]:
    """The library with every entry's argument types declared, or None
    where it is not built."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.sf_pfm_dims.argtypes = [ctypes.c_char_p, i32p]
    lib.sf_pfm_dims.restype = ctypes.c_int
    lib.sf_read_pfm.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64]
    lib.sf_read_pfm.restype = ctypes.c_int
    lib.sf_crop_normalize.argtypes = [
        f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, f32p, f32p, f32p,
    ]
    lib.sf_crop_normalize.restype = ctypes.c_int
    lib.sf_png_dims.argtypes = [ctypes.c_char_p, i32p]
    lib.sf_png_dims.restype = ctypes.c_int
    lib.sf_read_png.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int64]
    lib.sf_read_png.restype = ctypes.c_int
    lib.sf_read_png_u16.argtypes = [ctypes.c_char_p, u16p, ctypes.c_int64]
    lib.sf_read_png_u16.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def read_pfm(path: str) -> np.ndarray:
    """Native PFM decode, rows top-down. Raises where the library is not
    built or the file does not decode."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native IO library not built (make -C native)")
    dims = np.zeros(3, np.int32)
    rc = lib.sf_pfm_dims(path.encode(), dims)
    if rc:
        raise IOError(f"sf_pfm_dims({path}) -> {rc}")
    h, w, c = (int(x) for x in dims)
    out = np.empty(h * w * c, np.float32)
    rc = lib.sf_read_pfm(path.encode(), out, out.size)
    if rc:
        raise IOError(f"sf_read_pfm({path}) -> {rc}")
    return out.reshape((h, w, 3) if c == 3 else (h, w))


def _png_fallback(path: str, call: str, rc: int) -> None:
    """A failed native PNG decode falls back to PIL (the caller returns
    None), which may still read a file the native decoder rejects;
    ``STEREOFORMER_NATIVE_STRICT=1`` raises instead. The first failure
    other than an unsupported layout (-20) is logged."""
    if os.environ.get("STEREOFORMER_NATIVE_STRICT", "0") == "1":
        raise IOError(f"{call}({path}) -> {rc}")
    global _warned_fallback
    if rc != -20 and not _warned_fallback:
        _warned_fallback = True
        logging.getLogger(__name__).warning(
            "native PNG decode failed (%s(%s) -> %d); falling back to PIL "
            "(further fallbacks silent)", call, path, rc)


def read_png_rgb(path: str) -> Optional[np.ndarray]:
    """Native PNG decode -> float32 RGB [H, W, 3], as PIL's
    ``convert("RGB")`` gives it (gray replicated, alpha dropped); None
    where the library is not built or the decode fails."""
    lib = load_library()
    if lib is None:
        return None
    dims = np.zeros(4, np.int32)
    rc = lib.sf_png_dims(path.encode(), dims)
    if rc:
        _png_fallback(path, "sf_png_dims", rc)
        return None
    h, w, c = (int(x) for x in dims[:3])
    out = np.empty(h * w * c, np.uint8)
    rc = lib.sf_read_png(path.encode(), out, out.size)
    if rc:
        _png_fallback(path, "sf_read_png", rc)
        return None
    img = out.reshape(h, w, c)
    if c == 1:
        img = np.repeat(img, 3, axis=2)
    elif c == 2:       # gray and alpha: convert("RGB") keeps the gray
        img = np.repeat(img[:, :, :1], 3, axis=2)
    elif c == 4:       # RGBA: convert("RGB") drops alpha
        img = img[:, :, :3]
    return np.ascontiguousarray(img).astype(np.float32)


def read_png_gray16(path: str) -> Optional[np.ndarray]:
    """Native 16-bit gray PNG decode (KITTI's disparity encoding) -> uint16
    [H, W]; None where the library is not built, the file is not 16-bit
    gray, or the decode fails."""
    lib = load_library()
    if lib is None:
        return None
    dims = np.zeros(4, np.int32)
    rc = lib.sf_png_dims(path.encode(), dims)
    if rc:
        _png_fallback(path, "sf_png_dims", rc)
        return None
    h, w, c, depth = (int(x) for x in dims)
    if depth != 16 or c != 1:
        return None
    out = np.empty(h * w, np.uint16)
    rc = lib.sf_read_png_u16(path.encode(), out, out.size)
    if rc:
        _png_fallback(path, "sf_read_png_u16", rc)
        return None
    return out.reshape(h, w)


def crop_normalize(img: np.ndarray, oy: int, ox: int, ch: int, cw: int,
                   mean: np.ndarray, std: np.ndarray,
                   pre_scale: float = 1.0 / 255.0) -> np.ndarray:
    """Crop [oy:oy+ch, ox:ox+cw], scale by ``pre_scale`` and normalise,
    in one pass where the library is built, else in numpy."""
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib = load_library()
    img = np.ascontiguousarray(img, np.float32)
    H, W, C = img.shape
    if lib is None:
        crop = img[oy:oy + ch, ox:ox + cw]
        return ((crop * pre_scale) - mean) / std
    if not (0 <= oy and oy + ch <= H and 0 <= ox and ox + cw <= W
            and mean.size == C and std.size == C):
        raise ValueError(f"crop {ch}x{cw} at ({oy}, {ox}) outside "
                         f"{H}x{W}x{C}, or mean/std not of {C} channels")
    out = np.empty((ch, cw, C), np.float32)
    rc = lib.sf_crop_normalize(img, H, W, C, oy, ox, ch, cw, pre_scale,
                               mean, std, out)
    if rc:
        raise ValueError(f"sf_crop_normalize -> {rc}")
    return out
