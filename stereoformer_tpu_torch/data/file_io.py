"""Image and disparity file IO (numpy).

Counterpart of ``read_img`` and ``write_pfm`` in
``stereoformer_tpu/data/file_io.py``; images decode through PIL.
"""

from __future__ import annotations

import numpy as np


def read_img(filename: str) -> np.ndarray:
    """RGB image as float32 [H, W, 3] in 0..255."""
    from PIL import Image

    with Image.open(filename) as img:
        return np.array(img.convert("RGB"), dtype=np.float32)


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
