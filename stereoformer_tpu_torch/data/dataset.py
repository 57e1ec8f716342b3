"""List-file stereo datasets and a synthetic one.

Counterpart of ``stereoformer_tpu/data/dataset.py``: list files of
space-separated ``left right [disp]`` lines (the ``filenames/`` format);
the named registry of KITTI, ETH3D and Middlebury lists; in val and test
mode the *images* are resized to ``scale_size`` (576x960 by default) while
the disparity keeps its own size; the KITTI pseudo-ground-truth paths.
``DummyStereoDataset`` makes textured pairs whose ground truth is exact by
construction, for tests and ``--dataset dummy``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .cache import open_cache
from .file_io import read_disp, read_img, read_text_lines

IMG_SIZE = (540, 960)     # SceneFlow's image size
SCALE_SIZE = (576, 960)   # the val/test image resize

_DATASET_LISTS = {
    # mode -> list file, relative to a filenames/ directory
    "KITTI2012": {
        "train": "KITTI_2012_train.txt",
        "train_all": "KITTI_2012_train_all.txt",
        "val": "KITTI_2012_val.txt",
        "test": "KITTI_2012_test.txt",
    },
    "KITTI2015": {
        "train": "KITTI_2015_train.txt",
        "train_all": "KITTI_2015_train_all.txt",
        "val": "KITTI_2015_val.txt",
        "test": "KITTI_2015_test.txt",
    },
    "KITTI_mix": {
        "train": "KITTI_mix_train.txt",
        "val": "KITTI_mix_val.txt",
        "test": "KITTI_2015_test.txt",
    },
    "ETH3D": {
        "train": "ETH3D.list",
        "val": "ETH3D_val.list",
        "test": "ETH3D_test.list",
    },
    "ETH3D_mix": {
        "train": "ETH3D_mix.list",
        "val": "ETH3D_mix_val.list",
        "test": "ETH3D_test.list",
    },
    "Middlebury": {
        "train": "Middleburry.list",   # upstream spelling
        "val": "Middleburry_val.list",
        "test": "Middleburry_test.list",
    },
}


def _resize_img(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of each channel through PIL."""
    from PIL import Image

    h, w = size
    out = np.stack(
        [
            np.array(
                Image.fromarray(img[..., c]).resize((w, h), Image.BILINEAR)
            )
            for c in range(img.shape[-1])
        ],
        axis=-1,
    )
    return out.astype(np.float32)


@dataclass
class SampleSpec:
    left: str
    right: str
    disp: Optional[str]
    pseudo_disp: Optional[str] = None
    left_name: Optional[str] = None


class StereoDataset:
    """Indexable dataset of sample dicts (numpy HWC float32).

    SceneFlow, and any name outside the registry, reads ``train_datalist``
    in train mode and ``test_datalist`` otherwise; a registry name reads
    its list for ``mode`` under ``filenames_dir`` (default ``filenames``).
    ``cache_dir`` turns on the decoded-sample cache (``data/cache.py``)."""

    def __init__(
        self,
        data_dir: str,
        train_datalist: str,
        test_datalist: str,
        dataset_name: str = "SceneFlow",
        mode: str = "train",
        save_filename: bool = False,
        load_pseudo_gt: bool = False,
        transform=None,
        filenames_dir: Optional[str] = None,
        scale_size: tuple[int, int] = SCALE_SIZE,
        cache_dir: Optional[str] = None,
    ):
        self._cache = open_cache(cache_dir)
        self.data_dir = data_dir
        self.mode = mode
        self.dataset_name = dataset_name
        self.save_filename = save_filename
        self.transform = transform
        self.img_size = IMG_SIZE
        self.scale_size = scale_size

        if dataset_name == "SceneFlow" or dataset_name not in _DATASET_LISTS:
            list_file = train_datalist if mode == "train" else test_datalist
        else:
            name = _DATASET_LISTS[dataset_name][mode]
            list_file = os.path.join(filenames_dir or "filenames", name)

        self.samples: list[SampleSpec] = []
        for line in read_text_lines(list_file):
            splits = line.split()
            left, right = splits[:2]
            disp = splits[2] if len(splits) > 2 else None
            pseudo = None
            if load_pseudo_gt and disp is not None:
                if "disp_occ_0" in disp:
                    pseudo = disp.replace("disp_occ_0", "disp_occ_0_pseudo_gt")
                elif "disp_occ" in disp:
                    pseudo = disp.replace("disp_occ", "disp_occ_pseudo_gt")
                else:
                    raise NotImplementedError(disp)
            self.samples.append(
                SampleSpec(
                    left=os.path.join(data_dir, left),
                    right=os.path.join(data_dir, right),
                    disp=os.path.join(data_dir, disp) if disp else None,
                    pseudo_disp=(os.path.join(data_dir, pseudo)
                                 if pseudo else None),
                    left_name=left.split("/", 1)[-1] if save_filename else None,
                )
            )

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> dict:
        spec = self.samples[index]
        c = self._cache
        rimg = c.img if c is not None else read_img
        rdisp = c.disp if c is not None else read_disp
        sample: dict = {
            "img_left": rimg(spec.left),
            "img_right": rimg(spec.right),
        }
        if spec.left_name:
            sample["left_name"] = spec.left_name
        subset = "subset" in self.dataset_name
        if spec.disp:
            sample["gt_disp"] = rdisp(spec.disp, subset=subset)
        if spec.pseudo_disp:
            sample["pseudo_disp"] = rdisp(spec.pseudo_disp, subset=subset)
        if self.mode in ("val", "test"):
            sample["img_left"] = _resize_img(sample["img_left"], self.scale_size)
            sample["img_right"] = _resize_img(sample["img_right"],
                                              self.scale_size)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample


class DummyStereoDataset:
    """Synthetic stereo pairs with exact ground truth: a smooth random
    texture, and a right view that is the left shifted by a smooth
    disparity field row by row. Sample ``index`` comes from a generator
    seeded by (seed, index) alone, so raw samples are cached across epochs
    (up to ``DUMMY_CACHE_SAMPLES``, default 192); the loader's
    augmentation still varies by epoch."""

    def __init__(
        self,
        length: int = 16,
        height: int = 384,
        width: int = 768,
        max_disp: float = 48.0,
        mode: str = "train",
        transform=None,
        seed: int = 0,
    ):
        self.length = length
        self.h, self.w = height, width
        self.max_disp = max_disp
        self.mode = mode
        self.transform = transform
        self.seed = seed
        self.img_size = (height, width)
        self.scale_size = (height, width)
        self._cache: dict = {}
        self._cache_max = min(
            length, int(os.environ.get("DUMMY_CACHE_SAMPLES", "192"))
        )
        yy, xx = np.mgrid[: self.h, : self.w].astype(np.float32)
        self._yy, self._xx = yy, xx

    def __len__(self):
        return self.length

    def _texture(self, rng):
        """Smooth multi-scale random texture, 0..255, gray in 3 channels."""
        img = np.zeros((self.h, self.w), np.float32)
        yy, xx = self._yy, self._xx
        for period in (7, 17, 41, 97):
            phase = rng.uniform(0, 2 * np.pi, (2,))
            img += rng.uniform(0.5, 1.0) * (
                np.sin(2 * np.pi * xx / period + phase[0])
                * np.sin(2 * np.pi * yy / period + phase[1])
            )
        img -= img.min()
        img *= 255.0 / max(img.max(), 1e-6)
        return np.repeat(img[..., None], 3, axis=-1)

    def _generate(self, index: int) -> dict:
        rng = np.random.default_rng(self.seed * 100003 + index)
        left = self._texture(rng)
        # a smooth disparity field in [4, max_disp]
        cy, cx = rng.uniform(0.2, 0.8, 2)
        yy, xx = self._yy, self._xx
        r = np.sqrt(((yy / self.h) - cy) ** 2 + ((xx / self.w) - cx) ** 2)
        disp = 4.0 + (self.max_disp - 4.0) * np.exp(-4.0 * r * r)
        # right(x) = left(x + disp), interpolated linearly along the row
        src = xx + disp
        x0 = np.clip(np.floor(src).astype(np.int64), 0, self.w - 1)
        x1 = np.clip(x0 + 1, 0, self.w - 1)
        t = (src - x0)[..., None]
        rows = np.arange(self.h)[:, None]
        right = left[rows, x0] * (1 - t) + left[rows, x1] * t
        return {
            "img_left": left.astype(np.float32),
            "img_right": right.astype(np.float32),
            "gt_disp": disp.astype(np.float32),
        }

    def __getitem__(self, index: int) -> dict:
        raw = self._cache.get(index)
        if raw is None:
            raw = self._generate(index)
            if len(self._cache) < self._cache_max:
                self._cache[index] = raw
        # copies: the transforms may change a sample in place
        sample = {k: v.copy() for k, v in raw.items()}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
