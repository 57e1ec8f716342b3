"""The PyTorch port's RAFT-Stereo against the JAX model, on the CPU.

The JAX variables are overwritten leaf by leaf with seeded numpy values
(conv kernels scaled to sqrt(1.25/fan_in), so float32 rounding does not grow
over the GRU steps; BatchNorm scale and variance drawn in [0.5, 1.5], means
and shifts nonzero, so a misplaced BatchNorm mapping shows), passed to the
port through ``weights.raft_state_dict_from_jax``, and both sides run the
same seeded inputs. The JAX model runs its eval path, whose correlation
lookup reads the blocked cache (``corr_block_cache``); its fused convs run
as XLA convs on the CPU, and the port's as the plain version of the fused
op. Also: the correlation ops, the factor-4 convex upsample, the group norm,
the weight bridge's round trip through the JAX package's converter,
reference checkpoint files, the registry and the inference CLI.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu import ops as jops  # noqa: E402
from stereoformer_tpu.models.raft_stereo import (  # noqa: E402
    RAFTStereo as JaxRAFTStereo,
)
from stereoformer_tpu.nn.raft.encoders import GroupNormNHWC  # noqa: E402
from stereoformer_tpu.train.torch_import import (  # noqa: E402
    convert_raft_state_dict,
)
from stereoformer_tpu_torch import ops  # noqa: E402
from stereoformer_tpu_torch.models import RAFTStereo, get_model  # noqa: E402
from stereoformer_tpu_torch.nn.raft import GroupNorm  # noqa: E402
from stereoformer_tpu_torch.weights import (  # noqa: E402
    load_state_dict_file,
    raft_state_dict_from_jax,
)

B, H, W = 1, 64, 128
ITERS = 3
# float32 on both sides, summed in other orders through ~40 convs and the
# GRU steps: disparities in px
TOL_PX = 1e-3
# encoder features and GRU states, relative to each output's largest value
FEAT_RTOL = 1e-4
# exact selections and one lerp: a few ulps of O(1) correlations
CORR_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _nchw(x):
    """NHWC numpy -> NCHW torch, channels_last (as the port's encoders
    hold activations)."""
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def _close_rel(got, want, rtol=FEAT_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _seeded_variables(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(node, name=""):
        if hasattr(node, "items"):
            return {k: fill(v, k) for k, v in node.items()}
        shape = node.shape
        if name == "kernel":
            std = np.sqrt(1.25 / np.prod(shape[:-1]))
            return (std * rng.standard_normal(shape)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return fill(shapes)


@pytest.fixture(scope="module")
def raft():
    """Seeded variables and inputs (raw 0..255 images), the JAX model, and
    the port's model with the bridged weights."""
    rng = np.random.default_rng(0)
    left = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    right = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    jmodel = JaxRAFTStereo()
    shapes = jax.eval_shape(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, iters=1,
                                 train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)
    model = RAFTStereo().eval()
    model.load_state_dict(raft_state_dict_from_jax(variables))
    return variables, left, right, jmodel, model


def _jax_eval(raft, **kw):
    variables, left, right, jmodel, _ = raft
    out = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False, **kw))(
        variables, left, right)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("test_mode,flow_init", [(False, False),
                                                  (True, False),
                                                  (False, True)],
                         ids=["all-iters", "test-mode", "flow-init"])
def test_raft_eval_matches_jax(raft, test_mode, flow_init):
    _, left, right, _, model = raft
    init = None
    if flow_init:
        rng = np.random.default_rng(7)
        init = (-3 + 2 * rng.standard_normal((B, H // 4, W // 4, 1))
                ).astype(np.float32)
    want = _jax_eval(raft, iters=ITERS, test_mode=test_mode,
                     flow_init=None if init is None else jnp.asarray(init))
    with torch.inference_mode():
        got = model(_t(left), _t(right), iters=ITERS, test_mode=test_mode,
                    flow_init=None if init is None else _t(init))
    for key in ("disp_low", "flow_low"):
        assert got[key].shape == want[key].shape == (B, H // 4, W // 4, 1)
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=TOL_PX)
    n = 1 if test_mode else ITERS
    assert len(got["disparities"]) == len(want["disparities"]) == n
    for g, w in zip(got["disparities"], want["disparities"]):
        assert g.shape == w.shape == (B, H, W, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL_PX)
    # the flow has moved: the comparison is not of zeros
    assert np.abs(want["disp_low"]).max() > 0.1


def test_encoders_match_jax(raft):
    variables, left, right, jmodel, model = raft
    jctx, jf1, jf2 = jmodel.apply(variables, left, right, train=False,
                                  method=JaxRAFTStereo.encode)
    with torch.inference_mode():
        ctx, f1, f2 = model.encode(_t(left), _t(right))
    _close_rel(f1.numpy(), jf1)
    _close_rel(f2.numpy(), jf2)
    assert len(ctx) == len(jctx) == 3
    for pair, jpair in zip(ctx, jctx):
        for got, want in zip(pair, jpair):
            _close_rel(_nhwc(got), want)


def test_update_block_matches_jax(raft):
    variables, _, _, jmodel, model = raft
    rng = np.random.default_rng(3)
    sizes = [(16, 32), (8, 16), (4, 8)]

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    net = [np.tanh(rand(B, h, w, 128)) for h, w in sizes]
    ctx = [tuple(0.5 * rand(B, h, w, 128) for _ in range(3)) for h, w in sizes]
    corr = rand(B, 16, 32, 36)
    flow = np.concatenate([3 * rand(B, 16, 32, 1),
                           np.zeros((B, 16, 32, 1), np.float32)], -1)
    jnet, jmask, jdelta = jmodel.apply(variables, net, ctx, corr, flow,
                                       method=JaxRAFTStereo.update)
    with torch.inference_mode():
        gnet, gmask, gdelta = model.update_block(
            [_nchw(n) for n in net],
            [tuple(_nchw(c) for c in cs) for cs in ctx],
            _nchw(corr), _nchw(flow))
    for got, want in zip(gnet, jnet):
        _close_rel(_nhwc(got), want)
    _close_rel(_nhwc(gmask), jmask)
    _close_rel(_nhwc(gdelta), jdelta)


def test_corr_ops_match_jax():
    """The all-pairs volume, the pyramid (odd widths drop their last
    column), and the lookup against the JAX package's eval lookup through
    the blocked cache, with centres inside, at and beyond the row's ends."""
    rng = np.random.default_rng(4)
    f1 = rng.standard_normal((2, 3, 21, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 3, 21, 16)).astype(np.float32)
    corr = ops.allpairs_corr1d(_t(f1), _t(f2))
    jcorr = jops.allpairs_corr1d(jnp.asarray(f1), jnp.asarray(f2))
    np.testing.assert_allclose(corr.numpy(), jcorr, rtol=0, atol=CORR_TOL)
    pyr = ops.corr_pyramid(corr, 4)
    jpyr = jops.corr_pyramid(jcorr, 4)
    assert [p.shape[-1] for p in pyr] == [21, 10, 5, 2]
    for p, jp in zip(pyr, jpyr):
        np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=CORR_TOL)
    coords = rng.uniform(-14, 35, (2, 3, 21)).astype(np.float32)
    coords[0, 0, :8] = [-5.0, 0.0, 20.0, 20.5, 25.0, -4.5, 3.0, 1e4]
    got = ops.corr_lookup(pyr, _t(coords), 4)
    cache = jops.corr_block_cache(jpyr, 4)
    want = jops.corr_lookup(jpyr, jnp.asarray(coords), 4, cache=cache)
    assert got.shape == want.shape == (2, 3, 21, 36)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CORR_TOL)
    # a centre far outside every level reads zeros
    assert not got[0, 0, 7].any()


@pytest.mark.parametrize("factor", [4, 8])
def test_upsample_convex_matches_jax(factor):
    rng = np.random.default_rng(5)
    disp = rng.standard_normal((2, 5, 7, 1)).astype(np.float32)
    mask = rng.standard_normal((2, 5, 7, 9 * factor ** 2)).astype(np.float32)
    got = ops.upsample_convex(_t(disp), _t(mask), factor)
    want = jops.upsample_convex(jnp.asarray(disp), jnp.asarray(mask), factor)
    assert got.shape == want.shape == (2, 5 * factor, 7 * factor, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("groups,affine", [(4, True), (16, False)],
                         ids=["group", "instance"])
def test_group_norm_matches_jax(groups, affine):
    """Applied, as an affine form, and from precomputed sums."""
    rng = np.random.default_rng(6)
    x = (3 + 2 * rng.standard_normal((2, 6, 9, 16))).astype(np.float32)
    jnorm = GroupNormNHWC(groups, use_scale=affine, use_bias=affine)
    jvars = jnorm.init(jax.random.PRNGKey(0), x)
    norm = GroupNorm(groups, 16, affine=affine)
    if affine:
        scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
        bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
        jvars = {"params": {"scale": scale, "bias": bias}}
        norm.load_state_dict({"weight": _t(scale), "bias": _t(bias)})
    xt = _nchw(x)
    _close_rel(_nhwc(norm(xt).detach()), jnorm.apply(jvars, x))
    s, t = norm(xt, stats_only=True)
    js, jt = jnorm.apply(jvars, x, stats_only=True)
    _close_rel(s.detach().numpy(), js)
    _close_rel(t.detach().numpy(), jt)
    sums = (xt.sum((2, 3)), xt.square().sum((2, 3)))
    _close_rel(_nhwc(norm(xt, precomputed_sums=sums).detach()),
               jnorm.apply(jvars, x))


def test_weight_bridge_round_trip(raft):
    variables = raft[0]
    sd = raft_state_dict_from_jax(variables)
    back = convert_raft_state_dict(sd, strict=True)
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)
    # the port's module takes the bridged keys exactly
    RAFTStereo().load_state_dict(sd, strict=True)


def test_reference_checkpoint_file_loads(tmp_path, raft):
    """A reference-style file: wrapped in {"state_dict"}, DataParallel
    prefixes, and each shortcut's ``downsample.1`` alias of norm3."""
    sd = raft_state_dict_from_jax(raft[0])
    ref = {"module." + k: v for k, v in sd.items()}
    for k, v in sd.items():
        if ".norm3." in k:
            ref["module." + k.replace(".norm3.", ".downsample.1.")] = v
    assert len(ref) > len(sd)
    path = tmp_path / "raft.pth"
    torch.save({"state_dict": ref}, path)
    loaded = load_state_dict_file(str(path))
    assert sorted(loaded) == sorted(sd)
    RAFTStereo().load_state_dict(loaded, strict=True)


def test_registry_defaults():
    """ImageNet-normalised inputs, and the shared contract's max_disp and
    loop are dropped; the options are the JAX model's (an option it lacks
    raises; ``test_torch_raft_options.py`` runs them); random weights
    repeat; eval mode; train mode supervises every iteration."""
    model = get_model("RAFT_Stereo", device="cpu", max_disp=192, loop="scan")
    with pytest.raises(TypeError):
        get_model("RAFT_Stereo", device="cpu", slow_fast_gru=True)
    assert model.input_norm == "imagenet" and not model.training
    again = get_model("RAFT_Stereo", device="cpu").state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, again[k]), k
    model.train()
    x = torch.zeros(1, 32, 64, 3)
    out = model(x, x, iters=2)
    assert [d.shape for d in out["disparities"]] == [(1, 32, 64, 1)] * 2
    assert all(bool(torch.isfinite(d).all()) for d in out["disparities"])


def test_infer_cli_raft_on_cpu(tmp_path, raft):
    """PNG files in, through the registry's ImageNet convention, padded to
    a multiple of 8 and cropped back."""
    from PIL import Image

    from stereoformer_tpu_torch.cli.infer import main

    rng = np.random.default_rng(8)
    paths = []
    for side in ("left", "right"):
        img = rng.integers(0, 256, (60, 124, 3), dtype=np.uint8)
        paths.append(tmp_path / f"{side}.png")
        Image.fromarray(img).save(paths[-1])
    weights = tmp_path / "raft.pth"
    torch.save(raft_state_dict_from_jax(raft[0]), weights)
    out = tmp_path / "disp.npy"
    disp = main(["--net", "RAFT_Stereo", "--left", str(paths[0]),
                 "--right", str(paths[1]), "--out", str(out), "--iters", "2",
                 "--device", "cpu", "--weights", str(weights)])
    assert disp.shape == (60, 124)
    assert np.isfinite(disp).all()
    np.testing.assert_array_equal(np.load(out), disp)
