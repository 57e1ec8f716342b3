"""Disparity-error pictures: the KITTI log-scale error colormap and the
TensorBoard panels of validation, in numpy.

Counterpart of ``stereoformer_tpu/utils/viz.py``.
"""

from __future__ import annotations

import numpy as np

# KITTI's error colormap rows: [low, high, r, g, b]
_KITTI_CMAP = np.array(
    [
        [0, 0.1875, 49, 54, 149],
        [0.1875, 0.375, 69, 117, 180],
        [0.375, 0.75, 116, 173, 209],
        [0.75, 1.5, 171, 217, 233],
        [1.5, 3, 224, 243, 248],
        [3, 6, 254, 224, 144],
        [6, 12, 253, 174, 97],
        [12, 24, 244, 109, 67],
        [24, 48, 215, 48, 39],
        [48, float("inf"), 165, 0, 38],
    ],
    dtype=np.float32,
)


def kitti_colormap() -> np.ndarray:
    return _KITTI_CMAP.copy()


def disp_error_image(pred: np.ndarray, gt: np.ndarray, abs_thres: float = 3.0,
                     rel_thres: float = 0.05) -> np.ndarray:
    """Colour-coded error map [H, W, 3] uint8: the error over the smaller
    of its two thresholds' scores, bucketed through the KITTI map; pixels
    without ground truth (<= 0) black."""
    pred = np.asarray(pred, np.float32)
    gt = np.asarray(gt, np.float32)
    valid = gt > 0
    err = np.abs(pred - gt)
    rel = err / np.maximum(np.abs(gt), 1e-6)
    score = np.minimum(err / abs_thres, rel / rel_thres)
    out = np.zeros(gt.shape + (3,), np.uint8)
    for lo, hi, r, g, b in _KITTI_CMAP:
        m = (score >= lo) & (score < hi) & valid
        out[m] = (r, g, b)
    return out


def tensorboard_disparity_images(writer, tag: str, left_img: np.ndarray,
                                 pred: np.ndarray, gt: np.ndarray,
                                 step: int) -> None:
    """Log the input, prediction, ground truth and error map of one sample
    to TensorBoard; nothing where ``writer`` is None. left_img [H, W, 3]
    (any scale), pred and gt [H, W]."""
    if writer is None:
        return
    img = left_img - left_img.min()
    img = img / max(float(img.max()), 1e-6)
    vmax = max(float(gt.max()), 1e-6)
    pred_v = np.clip(pred / vmax, 0, 1)
    gt_v = np.clip(gt / vmax, 0, 1)
    err = disp_error_image(pred, gt).astype(np.float32) / 255.0
    writer.add_image(f"{tag}/left", img, step, dataformats="HWC")
    writer.add_image(f"{tag}/pred", pred_v[None], step, dataformats="CHW")
    writer.add_image(f"{tag}/gt", gt_v[None], step, dataformats="CHW")
    writer.add_image(f"{tag}/error", err, step, dataformats="HWC")
