"""Host-side data of the port (numpy): file IO, transforms, datasets and
the loader."""

from .dataset import IMG_SIZE, SCALE_SIZE, DummyStereoDataset, StereoDataset
from .file_io import read_disp, read_img, read_pfm, read_text_lines, write_pfm
from .loader import DataLoader, DevicePrefetcher, num_workers_default
from .transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    lighting,
    normalize,
    random_color,
    random_crop,
    random_rescale,
    random_vertical_flip,
    to_unit,
    train_transform,
    val_transform,
)

__all__ = [
    "DataLoader",
    "DevicePrefetcher",
    "DummyStereoDataset",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "IMG_SIZE",
    "SCALE_SIZE",
    "StereoDataset",
    "lighting",
    "normalize",
    "num_workers_default",
    "random_color",
    "random_crop",
    "random_rescale",
    "random_vertical_flip",
    "read_disp",
    "read_img",
    "read_pfm",
    "read_text_lines",
    "to_unit",
    "train_transform",
    "val_transform",
    "write_pfm",
]
