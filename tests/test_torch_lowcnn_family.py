"""The rest of the LowCNN family in the port against the JAX models, on the
CPU: ``LowCNN`` (``refinement="fixed"``), ``LowCNN_simple`` ("none"),
``LowCNN_ada`` ("variance") and ``LowCNN_gru2`` ("gru_feature"), and the
options ``upsample="simple"`` and ``cost_volume="concat"``.

Each model runs at the small shapes of ``tests/test_torch_lowcnn.py``
(64x256, B=2) from seeded JAX variables bridged through
``weights.lowcnn_state_dict_from_jax``; the eval outputs agree within 1e-3
px. The family's ops (``disparity_variance``, both branches of
``variance_local_cost_volume``, ``fixed_local_cost_volume``,
``make_candidates``' ``extra_invalid``, ``upsample_simple8``,
``concat_volume``) are each held against JAX in value and gradient.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from test_torch_lowcnn import _seeded_variables  # noqa: E402

from stereoformer_tpu import ops as jops  # noqa: E402
from stereoformer_tpu.models.low_cnn import LowCNN as JaxLowCNN  # noqa: E402
from stereoformer_tpu.models.registry import get_model as jax_get_model  # noqa: E402
from stereoformer_tpu_torch import ops  # noqa: E402
from stereoformer_tpu_torch.models import LowCNN, available_models, get_model  # noqa: E402
from stereoformer_tpu_torch.weights import lowcnn_state_dict_from_jax  # noqa: E402

ITERS = 2
# f32 on both sides, summed in other orders through ~20 convs and the
# refinement; 1e-3 px is the stated bound (as for LowCNN_gru)
TOL_PX = 1e-3
# float32 op values and gradients of O(1)..O(24), sums in other orders:
# relative to the largest magnitude
OP_TOL = 1e-5
# the variance refiner's gradient passes a softmax, a variance sum, its
# square root, the candidates, the re-sample and a second softmax: each side
# lies up to 1e-5 (relative) from a float64 run of the port, and the two up
# to 1.1e-5 from each other (measured)
VARIANCE_TOL = 3e-5

# case -> the JAX LowCNN's options; the four registry names first
CONFIGS = {
    "LowCNN": {"refinement": "fixed"},
    "LowCNN_simple": {"refinement": "none"},
    "LowCNN_ada": {"refinement": "variance"},
    "LowCNN_gru2": {"refinement": "gru_feature"},
    "gru-simple-upsample": {"refinement": "gru", "upsample": "simple"},
    "fixed-concat-simple-upsample": {"refinement": "fixed",
                                     "cost_volume": "concat",
                                     "upsample": "simple"},
}
NAMES = ("LowCNN", "LowCNN_simple", "LowCNN_ada", "LowCNN_gru2")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 64, 256, 3)).astype(np.float32),
            rng.standard_normal((2, 64, 256, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_evals(images):
    """case -> (seeded variables, the JAX model's eval outputs), numpy."""
    left, right = images
    runs = {}
    for case, kw in CONFIGS.items():
        model = JaxLowCNN(**kw)
        shapes = jax.eval_shape(
            lambda a, b, m=model: m.init(jax.random.PRNGKey(0), a, b, iters=1,
                                         train=False), left, right)
        variables = _seeded_variables(shapes, seed=1)
        out = jax.jit(lambda v, a, b, m=model: m.apply(
            v, a, b, iters=ITERS, train=False))(variables, left, right)
        runs[case] = (variables, jax.tree_util.tree_map(np.asarray, out))
    return runs


@pytest.mark.parametrize("case", list(CONFIGS))
def test_eval_matches_jax(jax_evals, images, case):
    variables, want = jax_evals[case]
    model = LowCNN(**CONFIGS[case]).eval()
    model.load_state_dict(lowcnn_state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        got = model(_t(images[0]), _t(images[1]), iters=ITERS)
    np.testing.assert_allclose(got["disp_low"].numpy(), want["disp_low"],
                               rtol=0, atol=TOL_PX)
    assert len(got["disparities"]) == len(want["disparities"])
    for g, w in zip(got["disparities"], want["disparities"]):
        assert g.shape == w.shape == (2, 64, 256, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL_PX)
    if CONFIGS[case]["refinement"] in ("fixed", "variance"):
        # the refinement moved the disparity at some pixels, not at all
        d0, d1 = want["disparities"]
        moved = np.abs(d1 - d0) > 1e-3
        assert 0.01 < moved.mean() < 1.0, moved.mean()


@pytest.mark.parametrize("name", NAMES)
def test_registry_builds_the_family(name):
    model = get_model(name, device="cpu")
    assert name in available_models()
    assert model.refinement == jax_get_model(name).refinement
    assert model.upsample == "convex" and not model.concat
    sd = model.state_dict()
    # the non-GRU refinements share one mask from the left feature
    assert ("upsample_mask.upsample_mask.0.weight" in sd) == (
        name != "LowCNN_gru2")
    if name == "LowCNN_gru2":
        w = sd["local_cost_volume.feature_encode.weight"]
        assert w.shape == (64, 256, 3, 3)
        assert 0.5 < float(w.std() / np.sqrt(2.0 / (256 * 9))) < 1.5
        assert sd["local_cost_volume.gru.conv_z.weight"].shape[:2] == (128, 256)


LOWCNN_NAMES = ("LowCNN", "LowCNN_simple", "LowCNN_ada", "LowCNN_dynamic",
                "LowCNN_dynamic_supervised", "LowCNN_gru", "LowCNN_gru2")


@pytest.mark.parametrize("name", LOWCNN_NAMES)
def test_registry_takes_scan_unroll_as_jax_does(name):
    """JAX's LowCNN has a scan_unroll field, read only under loop="scan":
    every LowCNN name builds with it in both registries; the port's
    loop="scan" still raises."""
    assert name in available_models()
    assert jax_get_model(name, scan_unroll=1).scan_unroll == 1
    model = get_model(name, device="cpu", scan_unroll=1)
    assert model.refinement == jax_get_model(name).refinement
    with pytest.raises(NotImplementedError, match="scan"):
        get_model(name, device="cpu", loop="scan", scan_unroll=1)


@pytest.mark.parametrize("scan_unroll", [1, 2])
def test_trainers_take_scan_unroll_as_jax_does(scan_unroll):
    """Both trainers take scan_unroll under gru_loop="unroll" (JAX hands it
    to the model under gru_loop="scan" only; the port's loop is always
    unrolled)."""
    from stereoformer_tpu.train import DisparityTrainer as JaxTrainer
    from stereoformer_tpu_torch.train import DisparityTrainer

    kw = dict(lr=1e-3, dataset="dummy", gru_loop="unroll",
              scan_unroll=scan_unroll)
    assert JaxTrainer(**kw).scan_unroll == scan_unroll
    assert DisparityTrainer(**kw, device="cpu").scan_unroll == scan_unroll


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


@pytest.mark.parametrize("scan_unroll", ["1", "2"])
def test_cli_warns_on_scan_unroll_as_jax_does(tmp_path, monkeypatch,
                                               scan_unroll):
    """--scan_unroll N under --gru_loop unroll: both CLIs warn for N != 1
    and not for 1, before the trainer is built (stopped there)."""
    import warnings

    import stereoformer_tpu.train as jax_train
    import stereoformer_tpu_torch.train as port_train
    from stereoformer_tpu.cli.train import main as jax_main
    from stereoformer_tpu_torch.cli.train import main as port_main

    monkeypatch.setattr(jax_train, "DisparityTrainer", _stop)
    monkeypatch.setattr(port_train, "DisparityTrainer", _stop)
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        argv = ["--dataset", "dummy", "--gru_loop", "unroll",
                "--scan_unroll", scan_unroll, "--outf", str(tmp_path / "o"),
                "--save_logdir", str(tmp_path / "l")] + extra
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with pytest.raises(_Stop):
                main(argv)
        said = [w for w in seen if "--scan_unroll" in str(w.message)]
        assert len(said) == (scan_unroll != "1"), (main.__module__, seen)
        assert all(w.category is UserWarning for w in said)


def test_options_the_port_does_not_take_raise():
    with pytest.raises(ValueError, match="unknown refinement"):
        LowCNN(refinement="bogus")
    with pytest.raises(NotImplementedError, match="scan"):
        LowCNN(loop="scan")
    # bf16 builds and takes the float32 state dict; float16 raises
    bf16 = LowCNN(dtype=torch.bfloat16)
    bf16.load_state_dict(LowCNN().state_dict(), strict=True)
    assert all(v.dtype != torch.bfloat16 for v in bf16.state_dict().values())
    with pytest.raises(NotImplementedError, match="float16"):
        LowCNN(dtype=torch.float16)
    with pytest.raises(ValueError, match="unknown upsample"):
        LowCNN(upsample="nearest")
    with pytest.raises(ValueError, match="unknown cost_volume"):
        LowCNN(cost_volume="gwc")
    # upsample="simple" builds no affinity mask head
    assert not hasattr(LowCNN(refinement="none", upsample="simple"),
                       "upsample_mask")


# --- the family's ops, in value and gradient --------------------------------

def _torch_vjp(fn, inputs, g):
    ts = [_t(x).requires_grad_(True) for x in inputs]
    out = fn(*ts)
    return out.detach().numpy(), [t.numpy() for t in torch.autograd.grad(
        out, ts, _t(g))]


def _jax_vjp(fn, inputs, g):
    out, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in inputs])
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _check(port_fn, jax_fn, inputs, out_shape, rng, tol=OP_TOL):
    g = rng.standard_normal(out_shape).astype(np.float32)
    got, got_grads = _torch_vjp(port_fn, inputs, g)
    want, want_grads = _jax_vjp(jax_fn, inputs, g)
    assert got.shape == want.shape == out_shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))
    for a, b in zip(got_grads, want_grads):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(1.0, np.abs(b).max()))


def _volume_and_disp(rng, shape=(2, 5, 40, 24)):
    vol = (2 * rng.standard_normal(shape)).astype(np.float32)
    disp = rng.uniform(-1, 25, shape[:3] + (1,)).astype(np.float32)
    return vol, disp


@pytest.mark.parametrize("keepdim", [True, False], ids=["B,H,W,1", "B,H,W"])
def test_disparity_variance_matches_jax(keepdim):
    rng = np.random.default_rng(1)
    vol, disp = _volume_and_disp(rng)
    prob = np.asarray(jax.nn.softmax(vol, axis=-1))
    cur = disp if keepdim else disp[..., 0]
    _check(ops.disparity_variance, jops.softargmin.disparity_variance,
           [prob, cur], disp.shape, rng)


@pytest.mark.parametrize("consider_valid", [True, False],
                         ids=["collapse", "clamp"])
def test_fixed_local_cost_volume_matches_jax(consider_valid):
    rng = np.random.default_rng(2)
    vol, disp = _volume_and_disp(rng)
    _check(lambda v, d: ops.fixed_local_cost_volume(v, d, 2.0, 20,
                                                    consider_valid),
           lambda v, d: jops.fixed_local_cost_volume(v, d, 2.0, 20,
                                                     consider_valid),
           [vol, disp], disp.shape, rng)


@pytest.mark.parametrize("consider_valid", [True, False],
                         ids=["border-test", "clamp"])
def test_variance_local_cost_volume_matches_jax(consider_valid):
    rng = np.random.default_rng(3)
    vol, disp = _volume_and_disp(rng)
    _check(lambda v, d: ops.variance_local_cost_volume(v, d, 1.0, 20,
                                                       consider_valid),
           lambda v, d: jops.variance_local_cost_volume(v, d, 1.0, 20,
                                                        consider_valid),
           [vol, disp], disp.shape, rng, VARIANCE_TOL)
    if consider_valid:
        # the image-border test invalidates the pixels whose upper bound
        # passes their own column: their disparity stays as it came
        B, H, W, D = vol.shape
        prob = jax.nn.softmax(vol, axis=-1)
        sigma = np.asarray(jops.softargmin.disparity_variance(prob, disp))
        border = (disp + sigma > np.arange(W)[:, None]) & (disp - sigma >= 0) \
            & (disp + sigma < D - 1)
        assert border.any()
        got = ops.variance_local_cost_volume(_t(vol), _t(disp), 1.0, 20,
                                             True).numpy()
        np.testing.assert_allclose(got[border], disp[border], rtol=0,
                                   atol=OP_TOL * 24)


def test_make_candidates_extra_invalid_matches_jax():
    rng = np.random.default_rng(4)
    shape = (2, 5, 40, 1)
    cur = rng.uniform(0, 23, shape).astype(np.float32)
    lower = (cur - rng.uniform(0, 3, shape)).astype(np.float32)
    upper = (cur + rng.uniform(0, 3, shape)).astype(np.float32)
    extra = (rng.random(shape) < 0.3).astype(np.float32)
    _check(lambda lo, up, c: ops.make_candidates(lo, up, c, 20, 24,
                                                 extra_invalid=_t(extra)),
           lambda lo, up, c: jops.make_candidates(lo, up, c, 20, 24,
                                                  extra_invalid=extra),
           [lower, upper, cur], shape[:3] + (21,), rng)
    got = ops.make_candidates(_t(lower), _t(upper), _t(cur), 20, 24,
                              extra_invalid=_t(extra)).numpy()
    flagged = extra[..., 0] > 0
    np.testing.assert_array_equal(
        got[flagged], np.broadcast_to(cur, got.shape)[flagged])


def test_upsample_simple8_matches_jax():
    rng = np.random.default_rng(5)
    disp = rng.uniform(0, 23, (2, 5, 9, 1)).astype(np.float32)
    _check(ops.upsample_simple8, jops.upsample_simple8, [disp],
           (2, 40, 72, 1), rng)


@pytest.mark.parametrize("W", [40, 10], ids=["W>D", "W<D"])
def test_concat_volume_matches_jax(W):
    rng = np.random.default_rng(6)
    left = rng.standard_normal((2, 3, W, 8)).astype(np.float32)
    right = rng.standard_normal((2, 3, W, 8)).astype(np.float32)
    _check(lambda a, b: ops.concat_volume(a, b, 24),
           lambda a, b: jops.concat_volume(a, b, 24),
           [left, right], (2, 3, W, 24, 16), rng)
    got = ops.concat_volume(_t(left), _t(right), 24).numpy()
    for d in range(24):
        # the whole 2C slice, the left half included, is zero where w < d
        assert not got[:, :, :min(d, W), d].any()


@pytest.mark.parametrize("name", ["LowCNN", "LowCNN_gru2"])
def test_infer_cli_runs_the_family(tmp_path, name):
    from PIL import Image

    from stereoformer_tpu_torch.cli.infer import main

    rng = np.random.default_rng(7)
    paths = []
    for side in ("left", "right"):
        img = rng.integers(0, 256, (60, 124, 3), dtype=np.uint8)
        paths.append(tmp_path / f"{side}.png")
        Image.fromarray(img).save(paths[-1])
    out = tmp_path / "disp.npy"
    disp = main(["--left", str(paths[0]), "--right", str(paths[1]),
                 "--out", str(out), "--device", "cpu", "--net", name,
                 "--iters", "2"])
    assert disp.shape == (60, 124)
    assert np.isfinite(disp).all()
