"""Disk cache of decoded samples: from the second epoch on, no PNG or PFM
decode.

Counterpart of ``stereoformer_tpu/data/cache.py``. The decoded arrays,
before augmentation, are stored one ``.npy`` each, keyed by the source's
absolute path, size and modification time, so a changed source file misses
its entry. Images are kept as uint8 (``read_img`` gives integral 0..255
values for 8-bit sources, so the round trip is exact), disparities as their
float32. An entry is written to a temporary name and renamed into place,
so workers and processes sharing the directory never read half of one.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Optional

import numpy as np

from .file_io import read_disp, read_img


class DecodedSampleCache:
    """One ``.npy`` per decoded array under ``cache_dir``."""

    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _key(self, path: str, tag: str) -> str:
        st = os.stat(path)
        ident = (f"{os.path.abspath(path)}|{st.st_size}|"
                 f"{st.st_mtime_ns}|{tag}")
        h = hashlib.sha1(ident.encode()).hexdigest()
        return os.path.join(self.dir, h[:2], h + ".npy")

    def _get(self, path: str, tag: str, decode) -> np.ndarray:
        key = self._key(path, tag)
        try:
            return np.load(key)
        except (FileNotFoundError, ValueError, EOFError):
            pass  # a miss, or a corrupt entry: decode and write it anew
        val = decode(path)
        os.makedirs(os.path.dirname(key), exist_ok=True)
        tmp = f"{key}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            with open(tmp, "wb") as f:
                np.save(f, val)
            os.replace(tmp, key)
        except OSError:
            # a full or read-only cache directory: serve the decode uncached
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return val

    def img(self, path: str) -> np.ndarray:
        """``read_img`` through the cache (float32 [H, W, 3], 0..255)."""
        u8 = self._get(path, "img_u8", lambda p: read_img(p).astype(np.uint8))
        return u8.astype(np.float32)

    def disp(self, path: str, subset: bool = False) -> np.ndarray:
        """``read_disp`` through the cache (float32)."""
        return self._get(path, f"disp_subset={int(subset)}",
                         lambda p: read_disp(p, subset=subset))


def open_cache(cache_dir: Optional[str]) -> Optional[DecodedSampleCache]:
    return DecodedSampleCache(cache_dir) if cache_dir else None
