"""The port's host data path against the JAX package's, on the CPU.

The same files (PNG, PFM, KITTI 16-bit PNG and list files, written here)
and the same seeds go through both packages' file readers, transforms,
datasets, decoded-sample cache and loaders; every array must be bit-equal.
Where the native IO library (``native/libstereoformer_io.so``) is built,
each case runs twice: through it, and through the numpy/PIL path with the
library hidden from both packages; else the native cases skip. Also: a
worker's error raised in the consumer, the port's ``DevicePrefetcher`` on
the CPU (order and content), and the utilities (loss scheme, meter, error
colormap) against JAX.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from PIL import Image  # noqa: E402

from stereoformer_tpu import data as jdata  # noqa: E402
from stereoformer_tpu.data import cache as jcache  # noqa: E402
from stereoformer_tpu.data import dataset as jdataset  # noqa: E402
from stereoformer_tpu.data import native as jnative  # noqa: E402
from stereoformer_tpu.data import transforms as jtransforms  # noqa: E402
from stereoformer_tpu.utils import common as jcommon  # noqa: E402
from stereoformer_tpu.utils import viz as jviz  # noqa: E402
from stereoformer_tpu_torch import data  # noqa: E402
from stereoformer_tpu_torch.data import cache  # noqa: E402
from stereoformer_tpu_torch.data import dataset  # noqa: E402
from stereoformer_tpu_torch.data import native  # noqa: E402
from stereoformer_tpu_torch.data import transforms  # noqa: E402
from stereoformer_tpu_torch.utils import common, viz  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["native", "numpy"])
def io_path(request, monkeypatch):
    """Both packages through the native library ("native", skipped where
    it is not built) or through numpy and PIL with it hidden ("numpy")."""
    if request.param == "native":
        if not (native.available() and jnative.available()):
            pytest.skip("native library not built (make -C native)")
    else:
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_LIB_PATH", "/nonexistent/lib.so")
        assert not native.available() and not jnative.available()
    return request.param


def _equal(got, want):
    """Bit-equality of two sample or batch dicts (or arrays)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
        return
    if isinstance(want, list):
        assert got == want
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _sample(seed=0, h=40, w=56, normal=False):
    rng = np.random.default_rng(seed)
    s = {"img_left": rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
         "img_right": rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
         "gt_disp": rng.uniform(0, 40, (h, w)).astype(np.float32)}
    if normal:
        s["gt_normal"] = rng.standard_normal((h, w, 3)).astype(np.float32)
    return s


def _copy(s):
    return {k: v.copy() for k, v in s.items()}


def _both(fn_port, fn_jax, sample, seed=None):
    """Run both transforms on copies of ``sample`` with generators from
    ``seed``; check the samples and the generators' next draws agree."""
    rngs = [None, None] if seed is None else [np.random.default_rng(seed)
                                              for _ in range(2)]
    got = fn_port(_copy(sample), rngs[0])
    want = fn_jax(_copy(sample), rngs[1])
    _equal(got, want)
    if seed is not None:
        assert rngs[0].random() == rngs[1].random()
    return got


# --- files -----------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A little SceneFlow- and KITTI-shaped tree: 6 PNG pairs (RGB, gray and
    RGBA), PFM disparities (little-endian and big-endian), KITTI 16-bit PNG
    disparities, an .npy, and list files."""
    root = tmp_path_factory.mktemp("stereo")
    rng = np.random.default_rng(7)
    h, w = 36, 52
    lines, kitti = [], []
    for i in range(6):
        mode = ("RGB", "L", "RGBA")[i % 3]
        chans = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
        for side in ("left", "right"):
            arr = rng.integers(0, 256, (h, w, chans), dtype=np.uint8)
            Image.fromarray(arr[..., 0] if chans == 1 else arr, mode).save(
                root / f"{side}{i}.png")
        disp = rng.uniform(0.5, 60, (h, w)).astype(np.float32)
        disp[0, :3] = 0.0
        if i % 2:
            with open(root / f"disp{i}.pfm", "wb") as f:   # big-endian
                f.write(f"Pf\n{w} {h}\n1.0\n".encode())
                np.flipud(disp).astype(">f4").tofile(f)
        else:
            jdata.write_pfm(str(root / f"disp{i}.pfm"), disp)
        lines.append(f"left{i}.png right{i}.png disp{i}.pfm")
        k16 = (disp * 256).astype(np.uint16)
        Image.fromarray(k16).save(root / f"disp_occ_0_{i}.png")
        Image.fromarray(k16 // 2).save(root / f"disp_occ_0_pseudo_gt_{i}.png")
        kitti.append(f"left{i}.png right{i}.png disp_occ_0_{i}.png")
    np.save(root / "disp.npy", rng.uniform(0, 9, (h, w)).astype(np.float32))
    (root / "train.list").write_text("\n".join(lines[:4]) + "\n\n")
    (root / "val.list").write_text("\n".join(lines[4:]) + "\n")
    names = root / "filenames"
    names.mkdir()
    (names / "KITTI_2015_train.txt").write_text("\n".join(kitti[:4]))
    (names / "KITTI_2015_val.txt").write_text("\n".join(kitti[4:]))
    return root


@pytest.mark.parametrize("name", ["disp0.pfm", "disp1.pfm"])
def test_read_pfm_matches_jax(files, name):
    got, got_scale = data.read_pfm(str(files / name))
    want, want_scale = jdata.read_pfm(str(files / name))
    _equal(got, want)
    assert got_scale == want_scale


@pytest.mark.parametrize("name,subset", [
    ("disp0.pfm", False), ("disp1.pfm", False), ("disp0.pfm", True),
    ("disp_occ_0_2.png", False), ("disp.npy", False)])
def test_read_disp_matches_jax(files, io_path, name, subset):
    path = str(files / name)
    _equal(data.read_disp(path, subset=subset),
           jdata.read_disp(path, subset=subset))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_read_img_matches_jax(files, io_path, i):
    """RGB, gray and RGBA PNGs."""
    path = str(files / f"left{i}.png")
    got = data.read_img(path)
    assert got.shape == (36, 52, 3)
    _equal(got, jdata.read_img(path))


def test_read_disp_rejects_unknown_suffix(files):
    with pytest.raises(ValueError, match="invalid disparity"):
        data.read_disp(str(files / "train.list"))


def test_read_text_lines_matches_jax(files):
    path = str(files / "train.list")
    assert data.read_text_lines(path) == jdata.read_text_lines(path)
    assert len(data.read_text_lines(path)) == 4


# --- transforms ------------------------------------------------------------

@pytest.mark.parametrize("name,sample_kw", [
    ("random_crop", {}), ("random_crop_validate", {}),
    ("random_crop_pad", {}), ("random_crop_pad_both", {}),
    ("random_vertical_flip", {"normal": True}), ("random_color", {}),
    ("lighting", {}), ("random_rescale", {}), ("to_unit_normalize", {})])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_transform_matches_jax(name, sample_kw, seed):
    def call(T):
        return {
            "random_crop": lambda s, r: T.random_crop(s, 24, 32, r),
            "random_crop_validate": lambda s, r: T.random_crop(
                s, 24, 32, r, validate=True),
            "random_crop_pad": lambda s, r: T.random_crop(s, 48, 40, r),
            "random_crop_pad_both": lambda s, r: T.random_crop(s, 48, 64, r),
            "random_vertical_flip": T.random_vertical_flip,
            "random_color": T.random_color,
            "lighting": lambda s, r: T.lighting(s, r, alphastd=0.5),
            "random_rescale": lambda s, r: T.random_rescale(s, (29, 71)),
            "to_unit_normalize": lambda s, r: T.normalize(T.to_unit(s)),
        }[name]

    _both(call(transforms), call(jtransforms),
          _sample(seed, **sample_kw), seed=100 + seed)


@pytest.mark.parametrize("fn,param", [
    ("_adjust_contrast", 1.13), ("_adjust_gamma", 0.77),
    ("_adjust_brightness", 1.6), ("_adjust_hue", -0.07),
    ("_adjust_saturation", 0.85)])
def test_adjust_matches_jax(fn, param):
    img = _sample(5)["img_left"]
    _equal(getattr(transforms, fn)(img.copy(), param),
           getattr(jtransforms, fn)(img.copy(), param))


def test_random_color_one_jitter_for_both_views():
    s = _sample(3)
    s["img_right"] = s["img_left"].copy()
    for seed in range(8):
        out = transforms.random_color(_copy(s), np.random.default_rng(seed))
        _equal(out["img_left"], out["img_right"])


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_transform_matches_jax(io_path, color, seed):
    """The native fused crop-normalize draws x then y, as random_crop."""
    _both(lambda s, r: transforms.train_transform(s, r, crop=(24, 32),
                                                  color=color),
          lambda s, r: jtransforms.train_transform(s, r, crop=(24, 32),
                                                   color=color),
          _sample(seed), seed=seed)


def test_train_transform_pads_a_small_image(io_path):
    _both(lambda s, r: transforms.train_transform(s, r, crop=(48, 64)),
          lambda s, r: jtransforms.train_transform(s, r, crop=(48, 64)),
          _sample(4), seed=4)


def test_val_transform_matches_jax():
    _both(lambda s, r: transforms.val_transform(s),
          lambda s, r: jtransforms.val_transform(s), _sample(6))


# --- datasets --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "val"])
def test_dummy_dataset_matches_jax(mode):
    kw = dict(length=3, height=24, width=40, max_disp=12.0, mode=mode,
              seed=0 if mode == "train" else 1)
    ours, theirs = data.DummyStereoDataset(**kw), jdata.DummyStereoDataset(**kw)
    assert len(ours) == len(theirs) == 3
    for i in (0, 2, 0):
        _equal(ours[i], theirs[i])


def _stereo(pkg, files, mode, **kw):
    return pkg.StereoDataset(str(files), str(files / "train.list"),
                             str(files / "val.list"), mode=mode, **kw)


@pytest.mark.parametrize("mode,kw", [
    ("train", {}), ("val", {}), ("val", {"scale_size": (40, 64)}),
    ("test", {"scale_size": (32, 48), "save_filename": True})])
def test_stereo_dataset_matches_jax(files, io_path, mode, kw):
    ours, theirs = _stereo(data, files, mode, **kw), _stereo(jdata, files,
                                                             mode, **kw)
    assert len(ours) == len(theirs) == (4 if mode == "train" else 2)
    for i in range(len(ours)):
        _equal(ours[i], theirs[i])
    if mode != "train":
        assert ours[0]["img_left"].shape[:2] == kw.get("scale_size",
                                                       (576, 960))


def test_stereo_dataset_registry_and_pseudo_gt_match_jax(files, io_path):
    kw = dict(dataset_name="KITTI2015", filenames_dir=str(files / "filenames"),
              load_pseudo_gt=True)
    for mode in ("train", "val"):
        ours, theirs = _stereo(data, files, mode, **kw), _stereo(
            jdata, files, mode, **kw)
        assert [vars(s) for s in ours.samples] == [vars(s) for s in
                                                   theirs.samples]
        _equal(ours[1], theirs[1])
        assert "pseudo_disp" in ours[1]


def test_resize_img_matches_jax():
    img = _sample(8)["img_left"].round()
    _equal(dataset._resize_img(img, (50, 30)),
           jdataset._resize_img(img, (50, 30)))


# --- the decoded-sample cache -----------------------------------------------

def test_decoded_sample_cache_hits_and_invalidation(files, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("left0.png", "right0.png", "disp0.pfm"):
        (src / name).write_bytes((files / name).read_bytes())
    ours = cache.DecodedSampleCache(str(tmp_path / "ours"))
    theirs = jcache.DecodedSampleCache(str(tmp_path / "theirs"))

    def entries(c):
        return sorted(p for _, _, fs in os.walk(c.dir) for p in fs)

    for _ in range(2):   # a miss, then a hit
        _equal(ours.img(str(src / "left0.png")),
               theirs.img(str(src / "left0.png")))
        _equal(ours.disp(str(src / "disp0.pfm"), subset=True),
               theirs.disp(str(src / "disp0.pfm"), subset=True))
    # the same keys on both sides, one entry per array
    assert entries(ours) == entries(theirs) and len(entries(ours)) == 2
    # a changed source misses its entry
    arr = np.full((36, 52, 3), 9, np.uint8)
    Image.fromarray(arr).save(src / "left0.png")
    os.utime(src / "left0.png", ns=(1, 1))
    got = ours.img(str(src / "left0.png"))
    _equal(got, theirs.img(str(src / "left0.png")))
    _equal(got, arr.astype(np.float32))
    assert len(entries(ours)) == 3
    assert cache.open_cache(None) is None


def test_stereo_dataset_through_cache_matches_decode(files, tmp_path):
    plain = _stereo(data, files, "train")
    cached = _stereo(data, files, "train", cache_dir=str(tmp_path / "c"))
    for _ in range(2):
        for i in range(len(plain)):
            _equal(cached[i], plain[i])


# --- the loader --------------------------------------------------------------

def _loaders(ds_port, ds_jax, workers, **kw):
    def tf(T):
        return lambda s, rng: T.train_transform(s, rng, crop=(24, 32),
                                                color=True)

    return (data.DataLoader(ds_port, 2, shuffle=True, num_workers=workers,
                            seed=11, transform_with_rng=tf(transforms), **kw),
            jdata.DataLoader(ds_jax, 2, shuffle=True, num_workers=workers,
                             seed=11, transform_with_rng=tf(jtransforms),
                             **kw))


@pytest.mark.parametrize("workers", [0, 4])
def test_loader_batches_match_jax_over_two_epochs(workers):
    kw = dict(length=7, height=30, width=44, max_disp=10.0)
    ours, theirs = _loaders(data.DummyStereoDataset(**kw),
                            jdata.DummyStereoDataset(**kw), workers)
    assert len(ours) == len(theirs) == 3
    seen = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _equal(g, w)
            assert g["img_left"].shape == (2, 24, 32, 3)
            assert g["gt_disp"].shape == (2, 24, 32, 1)
        seen.append(got[0]["img_left"])
    assert not np.array_equal(seen[0], seen[1])   # the epochs differ


@pytest.mark.parametrize("workers", [0, 4])
def test_loader_over_files_matches_jax(files, io_path, workers):
    ours = data.DataLoader(_stereo(data, files, "val"), 3, num_workers=workers,
                           drop_last=False,
                           transform_with_rng=lambda s, r:
                           transforms.val_transform(s))
    theirs = jdata.DataLoader(_stereo(jdata, files, "val"), 3,
                              num_workers=workers, drop_last=False,
                              transform_with_rng=lambda s, r:
                              jtransforms.val_transform(s))
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 1
    _equal(got[0], want[0])


class _Failing:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise KeyError("sample 5 is broken")
        return _sample(i, 8, 8)


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_worker_error_raised_in_consumer(workers):
    loader = data.DataLoader(_Failing(), 2, num_workers=workers)
    with pytest.raises(KeyError, match="sample 5 is broken"):
        for _ in loader:
            pass


def test_loader_stops_early_without_leaking_its_producer():
    import threading

    before = threading.active_count()
    loader = data.DataLoader(data.DummyStereoDataset(length=12, height=16,
                                                     width=16),
                             2, num_workers=2, prefetch=1)
    for i, _ in enumerate(loader):
        if i == 1:
            break
    assert threading.active_count() == before


def test_prefetcher_on_cpu_keeps_order_and_content():
    ds = data.DummyStereoDataset(length=6, height=16, width=24)
    loader = data.DataLoader(ds, 2, shuffle=True, num_workers=2, seed=3)
    host = list(loader)
    batches = [dict(b, left_name=[f"n{i}"]) for i, b in enumerate(host)]
    out = list(data.DevicePrefetcher(batches, "cpu"))
    assert len(out) == len(host) == 3
    for i, (d, h) in enumerate(zip(out, host)):
        assert d["left_name"] == [f"n{i}"]
        for k, v in h.items():
            assert isinstance(d[k], torch.Tensor) and d[k].device.type == "cpu"
            _equal(d[k], v)


# --- utilities -----------------------------------------------------------------

def test_loss_scheme_and_meter_match_jax():
    path = os.path.join(REPO, "config", "loss_config_disp.json")
    assert common.load_loss_scheme(path) == jcommon.load_loss_scheme(path)
    ours, theirs = common.AverageMeter(), jcommon.AverageMeter()
    for v, n in ((3.0, 2), (0.5, 1), (7.25, 4)):
        ours.update(v, n)
        theirs.update(v, n)
    assert vars(ours) == vars(theirs)


def test_disp_error_image_matches_jax():
    rng = np.random.default_rng(2)
    gt = rng.uniform(-1, 80, (20, 30)).astype(np.float32)
    pred = gt + rng.normal(0, 6, gt.shape).astype(np.float32)
    _equal(viz.disp_error_image(pred, gt), jviz.disp_error_image(pred, gt))
    _equal(viz.kitti_colormap(), jviz.kitti_colormap())


def test_tensorboard_panels_match_jax():
    class Writer:
        def __init__(self):
            self.images = []

        def add_image(self, tag, img, step, dataformats):
            self.images.append((tag, np.asarray(img), step, dataformats))

    rng = np.random.default_rng(3)
    left = rng.standard_normal((12, 16, 3)).astype(np.float32)
    gt = rng.uniform(0, 30, (12, 16)).astype(np.float32)
    pred = gt + 1
    ours, theirs = Writer(), Writer()
    viz.tensorboard_disparity_images(ours, "val", left, pred, gt, 4)
    jviz.tensorboard_disparity_images(theirs, "val", left, pred, gt, 4)
    assert len(ours.images) == len(theirs.images) == 4
    for a, b in zip(ours.images, theirs.images):
        assert a[0] == b[0] and a[2:] == b[2:]
        _equal(a[1], b[1])
    viz.tensorboard_disparity_images(None, "val", left, pred, gt, 4)
