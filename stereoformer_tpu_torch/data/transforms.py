"""Sample-dict transforms with an explicit numpy random generator.

Counterpart of ``stereoformer_tpu/data/transforms.py``. A sample is a dict
of numpy arrays: ``img_left``/``img_right`` [H, W, 3] float32, optional
``gt_disp``/``pseudo_disp`` [H, W] (and ``gt_normal`` [H, W, 3], which
rides the geometric transforms). Every random transform takes a
``numpy.random.Generator`` and draws from it in the JAX package's order, so
the same generator gives the same sample bit for bit. Images stay NHWC
float32.
"""

from __future__ import annotations

import numpy as np

from . import native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_IMG_KEYS = ("img_left", "img_right")
_DENSE_KEYS = ("img_left", "img_right", "gt_disp", "pseudo_disp", "gt_normal")


def to_unit(sample: dict) -> dict:
    """Scale the images from 0..255 to 0..1."""
    for k in _IMG_KEYS:
        sample[k] = sample[k].astype(np.float32) / 255.0
    return sample


def normalize(sample: dict, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> dict:
    """ImageNet normalisation of the images."""
    for k in _IMG_KEYS:
        sample[k] = (sample[k] - mean) / std
    return sample


def random_crop(sample: dict, height: int, width: int,
                rng: np.random.Generator | None = None,
                validate: bool = False) -> dict:
    """Crop to (height, width); a smaller input is first padded with zeros
    at the top and on the right. Training draws a uniform offset (x, then
    y), validation (or no ``rng``) takes the centre."""
    H, W = sample["img_left"].shape[:2]
    if height > H or width > W:
        tp, rp = max(0, height - H), max(0, width - W)
        for k in _DENSE_KEYS:
            if k in sample and sample[k] is not None:
                pad = ((tp, 0), (0, rp)) + ((0, 0),) * (sample[k].ndim - 2)
                sample[k] = np.pad(sample[k], pad, mode="constant")
        H, W = sample["img_left"].shape[:2]
        if height <= H and width <= W:
            return random_crop(sample, height, width, rng, validate)
        return sample
    if validate or rng is None:
        ox, oy = (W - width) // 2, (H - height) // 2
    else:
        ox = int(rng.integers(0, W - width + 1))
        oy = int(rng.integers(0, H - height + 1))
    for k in _DENSE_KEYS:
        if k in sample and sample[k] is not None:
            sample[k] = sample[k][oy:oy + height, ox:ox + width]
    return sample


def random_vertical_flip(sample: dict, rng: np.random.Generator) -> dict:
    """Flip every dense key upside down with probability 0.5."""
    if rng.random() < 0.5:
        for k in _DENSE_KEYS:
            if k in sample and sample[k] is not None:
                sample[k] = np.ascontiguousarray(np.flipud(sample[k]))
    return sample


# photometric adjustments of 0..255 float images, torchvision's adjust_*
# without PIL, in the ranges of the reference's RandomColor

def _adjust_contrast(img, f):
    gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
    mean = gray.mean()
    return np.clip(f * img + (1 - f) * mean, 0, 255)


def _adjust_gamma(img, g):
    return np.clip(255.0 * (img / 255.0) ** g, 0, 255)


def _adjust_brightness(img, f):
    return np.clip(img * f, 0, 255)


def _adjust_saturation(img, f):
    gray = (img @ np.array([0.299, 0.587, 0.114], np.float32))[..., None]
    return np.clip(f * img + (1 - f) * gray, 0, 255)


def _adjust_hue(img, h):
    """Rotate the hue by ``h`` turns through HSV on 0..1."""
    x = img / 255.0
    mx, mn = x.max(-1), x.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    hch = np.where(
        mx == r, ((g - b) / diff) % 6,
        np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4),
    ) / 6.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    hch = (hch + h) % 1.0
    i = np.floor(hch * 6)
    f = hch * 6 - i
    p, q, t = mx * (1 - s), mx * (1 - f * s), mx * (1 - (1 - f) * s)
    i = i.astype(np.int32) % 6
    out = np.stack(
        [
            np.choose(i, [mx, q, p, p, t, mx]),
            np.choose(i, [t, mx, mx, q, p, p]),
            np.choose(i, [p, p, t, mx, mx, q]),
        ],
        axis=-1,
    )
    return np.clip(out * 255.0, 0, 255)


def random_color(sample: dict, rng: np.random.Generator) -> dict:
    """Photometric jitter of 0..255 images (before ``to_unit``): with
    probability 0.5 one adjustment picked at random, else all five in a
    random order; each is then applied with probability 0.5, its parameter
    drawn once for both views."""
    ops = [
        (_adjust_contrast, lambda: rng.uniform(0.8, 1.2)),
        (_adjust_gamma, lambda: rng.uniform(0.7, 1.5)),
        (_adjust_brightness, lambda: rng.uniform(0.5, 2.0)),
        (_adjust_hue, lambda: rng.uniform(-0.1, 0.1)),
        (_adjust_saturation, lambda: rng.uniform(0.8, 1.2)),
    ]
    idx = list(range(len(ops)))
    if rng.random() < 0.5:
        idx = [idx[int(rng.integers(len(idx)))]]
    else:
        rng.shuffle(idx)
    for i in idx:
        if rng.random() < 0.5:
            fn, draw = ops[i]
            param = draw()
            for k in _IMG_KEYS:
                sample[k] = fn(sample[k], param).astype(np.float32)
    return sample


# AlexNet's ImageNet PCA statistics, for ``lighting``
IMAGENET_PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
IMAGENET_PCA_EIGVEC = np.array(
    [
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ],
    np.float32,
)


def lighting(sample: dict, rng: np.random.Generator, alphastd: float = 0.1,
             eigval: np.ndarray = IMAGENET_PCA_EIGVAL,
             eigvec: np.ndarray = IMAGENET_PCA_EIGVEC) -> dict:
    """AlexNet's PCA lighting noise: add ``eigvec @ (alpha * eigval)`` to
    every pixel, one alpha drawn for both views, on whatever scale the
    images are in."""
    if alphastd == 0:
        return sample
    alpha = rng.normal(0, alphastd, size=3).astype(np.float32)
    rgb = (eigvec * alpha[None, :] * eigval[None, :]).sum(axis=1)
    for k in _IMG_KEYS:
        sample[k] = sample[k] + rgb
    return sample


def random_rescale(sample: dict, output_size: tuple[int, int]) -> dict:
    """Resize both views to ``output_size`` bilinearly (half-pixel
    centres). ``gt_disp`` is only cast to float32, neither resized nor
    rescaled, as the reference's (unused) transform left it."""
    def _resize(img: np.ndarray) -> np.ndarray:
        H, W = img.shape[:2]
        oh, ow = output_size
        ys = (np.arange(oh, dtype=np.float64) + 0.5) * H / oh - 0.5
        xs = (np.arange(ow, dtype=np.float64) + 0.5) * W / ow - 0.5
        ys, xs = np.clip(ys, 0, H - 1), np.clip(xs, 0, W - 1)
        y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
        y1 = np.clip(y0 + 1, 0, H - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
        x1 = np.clip(x0 + 1, 0, W - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        img = img.astype(np.float64)
        top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
        bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
        return (top * (1 - wy) + bot * wy).astype(np.float32)

    for k in _IMG_KEYS:
        sample[k] = _resize(sample[k])
    if sample.get("gt_disp") is not None:
        sample["gt_disp"] = sample["gt_disp"].astype(np.float32)
    return sample


def train_transform(sample: dict, rng: np.random.Generator,
                    crop=(320, 640), color: bool = False) -> dict:
    """The trainer's train pipeline: optional ``random_color``, then a
    random crop, /255 and ImageNet normalisation. Where the native library
    is built and the image covers the crop, the image passes run fused, one
    per image, from the same draws in the same order (x, then y)."""
    if color:
        sample = random_color(sample, rng)
    height, width = crop
    H, W = sample["img_left"].shape[:2]
    if H >= height and W >= width and native.available():
        ox = int(rng.integers(0, W - width + 1))
        oy = int(rng.integers(0, H - height + 1))
        for k in _IMG_KEYS:
            sample[k] = native.crop_normalize(
                sample[k], oy, ox, height, width, IMAGENET_MEAN, IMAGENET_STD)
        for k in _DENSE_KEYS[2:]:
            if k in sample and sample[k] is not None:
                sample[k] = sample[k][oy:oy + height, ox:ox + width]
        return sample
    sample = random_crop(sample, height, width, rng)
    return normalize(to_unit(sample))


def val_transform(sample: dict) -> dict:
    """/255 and ImageNet normalisation."""
    return normalize(to_unit(sample))
