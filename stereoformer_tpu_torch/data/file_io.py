"""Image and disparity file IO (numpy).

Counterpart of ``stereoformer_tpu/data/file_io.py``: RGB images as float32
0..255; PFM disparities (little- or big-endian, rows flipped to top-down);
KITTI 16-bit PNG disparities divided by 256; ``.npy`` as stored;
SceneFlow *subset* disparities, stored negative, flipped to positive. PNG
and PFM decode through the native library (``data/native.py``) where it is
built, else through PIL and numpy; both give the same arrays.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from . import native


def read_img(filename: str) -> np.ndarray:
    """RGB image as float32 [H, W, 3] in 0..255. PNGs decode through the
    native library where it is built; palette, 16-bit and interlaced PNGs
    and other formats through PIL."""
    if filename.lower().endswith(".png") and native.available():
        img = native.read_png_rgb(filename)
        if img is not None:
            return img
    from PIL import Image

    with Image.open(filename) as img:
        return np.array(img.convert("RGB"), dtype=np.float32)


def read_pfm(filename: str) -> tuple[np.ndarray, float]:
    """PFM reader: (the data, rows top-down, and the scale)."""
    with open(filename, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{filename}: not a PFM file")
        dim_line = f.readline().decode("ascii")
        m = re.match(r"^(\d+)\s(\d+)\s$", dim_line)
        if not m:
            raise ValueError(f"{filename}: malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), scale


def write_pfm(filename: str, data: np.ndarray, scale: float = 1.0) -> None:
    """Write an [H, W] or [H, W, 3] float32 array as PFM (rows bottom-up)."""
    data = np.asarray(data, np.float32)
    color = data.ndim == 3 and data.shape[2] == 3
    if data.ndim not in (2, 3):
        raise ValueError("PFM data must be HxW or HxWx3")
    endian = data.dtype.byteorder
    little = endian == "<" or (endian == "=" and np.little_endian)
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(f"{-scale if little else scale}\n".encode())
        np.flipud(data).tofile(f)


def _read_kitti_disp(filename: str) -> np.ndarray:
    """A KITTI 16-bit gray PNG, divided by 256."""
    if native.available():
        arr = native.read_png_gray16(filename)
        if arr is not None:
            return arr.astype(np.float32) / 256.0
    from PIL import Image

    with Image.open(filename) as img:
        return np.array(img, dtype=np.float32) / 256.0


def read_disp(filename: str, subset: bool = False) -> np.ndarray:
    """Disparity map [H, W] float32 from a PFM, KITTI PNG or ``.npy``
    file; ``subset`` negates a PFM's values (SceneFlow's subset)."""
    suffix = Path(filename).suffix.lower()
    if suffix == ".pfm":
        if native.available():
            disp = native.read_pfm(filename)
        else:
            disp = np.ascontiguousarray(read_pfm(filename)[0])
        if subset:
            disp = -disp
    elif suffix == ".png":
        disp = _read_kitti_disp(filename)
    elif suffix == ".npy":
        disp = np.load(filename)
    else:
        raise ValueError(f"invalid disparity file format: {filename}")
    return disp.astype(np.float32)


def read_text_lines(filepath: str) -> list[str]:
    """The file's non-empty lines, stripped."""
    with open(filepath) as f:
        return [line.strip() for line in f if line.strip()]
