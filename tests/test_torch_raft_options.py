"""RAFT-Stereo's options in the PyTorch port against the JAX model, on the CPU.

The option sets: the default; ``downsample=3, n_gru_layers=2`` (the
upstream real-time model's two options the JAX model has); ``downsample=1``;
``n_gru_layers=1, corr_levels=2, corr_radius=3``; ``hidden_dims=(96, 96,
96)``. For each, the JAX variables are seeded as in ``test_torch_raft.py``
and carried across by ``weights.raft_state_dict_from_jax``; the eval
disparities of every iteration are held to that file's bound. Also: the
bf16 eval of ``downsample=3, n_gru_layers=2`` within 1.5 times JAX's own
floor (``test_torch_raft_bf16.py``'s gate), a bf16 train step of three
sets, unequal hidden widths refused on
both sides, the registry passing the options through, reference-layout
files of each set, the fused conv's routing at every set, the convex
upsample at factors 2 and 8, and ``BottleneckBlock`` (no model calls it) in
value and gradient.
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
from stereoformer_tpu.nn.raft.encoders import (  # noqa: E402
    BottleneckBlock as JaxBottleneckBlock,
)
from stereoformer_tpu_torch import ops  # noqa: E402
from stereoformer_tpu_torch.models import RAFTStereo, get_model  # noqa: E402
from stereoformer_tpu_torch.nn.blocks import FusedConv, kernel_routes  # noqa: E402
from stereoformer_tpu_torch.nn.raft import BottleneckBlock  # noqa: E402
from stereoformer_tpu_torch.weights import (  # noqa: E402
    load_state_dict_file,
    module_state_dict_from_jax,
    raft_state_dict_from_jax,
)

from test_torch_bf16 import AGREEMENT_PX, FLOOR_FACTOR, ULP, _check, _mae  # noqa: E402
from test_torch_raft import TOL_PX, _seeded_variables  # noqa: E402

B, H, W, ITERS = 1, 64, 128, 2

OPTION_SETS = {
    "default": {},
    "ds3_gru2": dict(downsample=3, n_gru_layers=2),
    "ds1": dict(downsample=1),
    "gru1_corr2r3": dict(n_gru_layers=1, corr_levels=2, corr_radius=3),
    "hidden96": dict(hidden_dims=(96, 96, 96)),
}
# the modules each set builds beyond the default's, or lacks
ABSENT = {"ds3_gru2": ("update_block.gru32.", "cnet.layer5.",
                       "cnet.outputs32.", "context_zqr_convs.2."),
          "gru1_corr2r3": ("update_block.gru32.", "update_block.gru16.",
                           "cnet.layer4.", "cnet.layer5.", "cnet.outputs16.",
                           "cnet.outputs32.", "context_zqr_convs.1.")}
# BottleneckBlock: float32 on both sides, values relative to the largest
# output, gradients norm-wise relative (ReLU kinks within rounding of 0)
BOTTLENECK_RTOL = 1e-5
BOTTLENECK_GRAD_RTOL = 1e-4
# the biases of convs whose output a norm takes, relative to the norm of
# the conv's weight gradient (test_torch_raft_train.py's bound)
NORM_FED_BIAS_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _images(seed=0, b=B, h=H, w=W):
    rng = np.random.default_rng(seed)
    return ((255 * rng.random((b, h, w, 3))).astype(np.float32),
            (255 * rng.random((b, h, w, 3))).astype(np.float32))


def _jax_variables(jmodel, left, right, seed=1):
    shapes = jax.eval_shape(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, iters=1,
                                 train=False), left, right)
    return _seeded_variables(shapes, seed=seed)


@pytest.fixture(scope="module", params=list(OPTION_SETS))
def option_set(request):
    """(name, options, variables, images, JAX model, the port's model)."""
    opts = OPTION_SETS[request.param]
    left, right = _images()
    jmodel = JaxRAFTStereo(**opts)
    variables = _jax_variables(jmodel, left, right)
    model = RAFTStereo(**opts).eval()
    model.load_state_dict(raft_state_dict_from_jax(variables), strict=True)
    return request.param, opts, variables, (left, right), jmodel, model


def test_option_set_eval_matches_jax(option_set):
    _, opts, variables, (left, right), jmodel, model = option_set
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, a, b: jmodel.apply(v, a, b, iters=ITERS, train=False))(
        variables, left, right))
    with torch.inference_mode():
        got = model(_t(left), _t(right), iters=ITERS)
    f = 2 ** opts.get("downsample", 2)
    for key in ("disp_low", "flow_low"):
        assert got[key].shape == want[key].shape == (B, H // f, W // f, 1)
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=TOL_PX)
    assert len(got["disparities"]) == len(want["disparities"]) == ITERS
    for g, w in zip(got["disparities"], want["disparities"]):
        assert g.shape == w.shape == (B, H, W, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL_PX)
    assert np.abs(want["disp_low"]).max() > 0.1


def test_option_set_modules(option_set):
    """The port builds what the JAX model builds: the mask head's width,
    the context convs, the GRUs and the context net's levels."""
    name, opts, _, _, _, model = option_set
    sd = model.state_dict()
    f = 2 ** opts.get("downsample", 2)
    assert sd["update_block.mask.2.weight"].shape[0] == 9 * f * f
    levels = opts.get("n_gru_layers", 3)
    assert len(model.context_zqr_convs) == levels
    r, L = opts.get("corr_radius", 4), opts.get("corr_levels", 4)
    assert sd["update_block.encoder.convc1.weight"].shape[1] == L * (2 * r + 1)
    hd = opts.get("hidden_dims", (128,) * 3)[0]
    assert sd["update_block.gru08.convq.weight"].shape[0] == hd
    for prefix in ABSENT.get(name, ()):
        assert not any(k.startswith(prefix) for k in sd), prefix
    stem = sd["cnet.conv1.weight"]
    assert stem.shape == (64, 3, 7, 7)
    assert model.cnet.conv1.stride == (1 + (opts.get("downsample", 2) > 2),) * 2


def test_reference_files_of_option_sets_load(tmp_path, option_set):
    """A reference-layout file of each set (wrapped, DataParallel prefixes,
    the ``downsample.1`` aliases of norm3) loads strictly."""
    name, opts, variables, _, _, _ = option_set
    sd = raft_state_dict_from_jax(variables)
    ref = {"module." + k: v for k, v in sd.items()}
    ref.update({"module." + k.replace(".norm3.", ".downsample.1."): v
                for k, v in sd.items() if ".norm3." in k})
    path = tmp_path / f"{name}.pth"
    torch.save({"state_dict": ref}, path)
    loaded = load_state_dict_file(str(path))
    assert sorted(loaded) == sorted(sd)
    RAFTStereo(**opts).load_state_dict(loaded, strict=True)


# routed FusedConv sites a forward (both encoders) by option set: layer2's
# 64 -> 96 entry runs at stride 1 where downsample < 2, and layer3's
# 96 -> 128 entry where downsample = 0; JAX routes both
ROUTED_SITES = {"ds1": 16, "ds0": 18}


def test_fused_conv_routing_at_every_option_set():
    """JAX's rule (64 <= C_in <= 96) where the kernels can run and train
    the widths (C_in and Co 64, 96 or 128: the forward and the weight
    gradient have Co outputs, the dx conv C_in): 7 routed sites an encoder
    at most sets, 14 a forward; at ``downsample`` 1 and 0 layer2's
    64 -> 96 entry is routed too, 16 a forward, and at ``downsample=0``
    layer3's 96 -> 128 entry as well, 18 a forward."""
    for cin, cout in ((64, 64), (96, 96), (64, 96), (96, 64), (96, 128),
                      (64, 128)):
        assert kernel_routes(cin, cout), (cin, cout)
        assert FusedConv(cin, cout).routed
    for cin, cout in ((128, 128), (96, 160), (32, 32), (80, 80), (68, 64),
                      (104, 96), (56, 64), (72, 64), (88, 96), (72, 128)):
        assert not kernel_routes(cin, cout), (cin, cout)
        assert not FusedConv(cin, cout).routed
    for name, opts in (*OPTION_SETS.items(), ("ds0", dict(downsample=0))):
        with torch.device("meta"):
            model = RAFTStereo(**opts)
        routed = [n for n, m in model.named_modules()
                  if isinstance(m, FusedConv) and m.routed]
        want = ROUTED_SITES.get(name, 14)
        assert len(routed) == want, (opts, routed)
        assert sum(n.startswith("fnet.") for n in routed) == want // 2, opts
    for d in (0, 1):
        with torch.device("meta"):
            model = RAFTStereo(downsample=d)
        assert model.fnet.layer2[0].conv1.routed
        assert model.cnet.layer2[0].conv1.routed
    with torch.device("meta"):
        ds0 = RAFTStereo(downsample=0)
    for net in (ds0.fnet, ds0.cnet):
        assert isinstance(net.layer3[0].conv1, FusedConv)
        assert net.layer3[0].conv1.routed
        assert not net.layer3[0].conv2.routed


def test_fused_conv_unrouted_site_matches_plain_conv():
    """A site outside JAX's default range (C_in = 128 > auto_max_c) is the
    plain conv, its gradients autograd's, and launches nothing."""
    torch.manual_seed(0)
    conv = FusedConv(128, 128)
    assert not conv.routed
    x = torch.randn(2, 128, 6, 10).requires_grad_(True)
    n = ops.conv2d_fused.launches
    y, sums = conv(x, with_stats=True)
    assert sums is None and ops.conv2d_fused.launches == n
    want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_unequal_hidden_dims_refused_by_both():
    """JAX fails on a shape mismatch (context level 0 has hidden_dims[0]
    channels, gru08 is built with hidden_dims[2]); the port refuses at
    construction, naming the cause."""
    left, right = _images(h=64, w=96)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.eval_shape(lambda a, b: JaxRAFTStereo(
            hidden_dims=(64, 96, 128)).init(
            jax.random.PRNGKey(0), a, b, iters=1, train=False), left, right)
    with pytest.raises(ValueError, match="equal widths.*gru08"):
        RAFTStereo(hidden_dims=(64, 96, 128))
    with pytest.raises(ValueError, match="equal widths"):
        get_model("RAFT_Stereo", device="cpu", hidden_dims=(128, 128))


def test_registry_passes_options_through():
    model = get_model("RAFT_Stereo", device="cpu", downsample=3,
                      n_gru_layers=2, corr_levels=2, corr_radius=3,
                      max_disp=192)
    assert model.input_norm == "imagenet" and model.downsample == 3
    assert model.corr_levels == 2 and model.corr_radius == 3
    assert len(model.context_zqr_convs) == 2
    with pytest.raises(TypeError):
        get_model("RAFT_Stereo", device="cpu", shared_backbone=True)
    x = torch.zeros(1, 64, 96, 3)
    with torch.inference_mode():
        out = model(x, x, iters=2, test_mode=True)
    assert out["disparities"][0].shape == (1, 64, 96, 1)
    assert out["disp_low"].shape == (1, 8, 12, 1)


def test_raft_bf16_option_set_matches_jax():
    """``downsample=3, n_gru_layers=2`` in bf16: the port against JAX's
    bf16 within 1.5 times JAX's own floor (one bf16 ulp changed at 0.1% of
    the left image), and within bench.py's 0.25 px of JAX's float32."""
    opts = OPTION_SETS["ds3_gru2"]
    left, right = _images()
    j32 = JaxRAFTStereo(**opts)
    j16 = JaxRAFTStereo(dtype=jnp.bfloat16, **opts)
    variables = _jax_variables(j32, left, right)
    port = RAFTStereo(dtype=torch.bfloat16, **opts).eval()
    port.load_state_dict(raft_state_dict_from_jax(variables))

    def run(model, a):
        out = jax.jit(lambda v, a, b: model.apply(
            v, a, b, iters=ITERS, test_mode=True, train=False))(
            variables, a, right)
        return np.asarray(out["disparities"][-1])

    nudged = left.copy()
    pick = np.random.default_rng(9).random(left.shape) < 1e-3
    nudged[pick] *= 1 + ULP
    want32, want16, floor16 = (run(j32, left), run(j16, left),
                               run(j16, nudged))
    with torch.inference_mode():
        got = port(_t(left), _t(right), iters=ITERS,
                   test_mode=True)["disparities"][-1]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    got = got.numpy()
    floor, err = _mae(floor16, want16), _mae(got, want16)
    print(f"RAFT ds3 gru2 bf16: port-JAX {err:.4f} px, JAX floor "
          f"{floor:.4f}, JAX bf16-f32 {_mae(want16, want32):.4f}")
    assert err <= FLOOR_FACTOR * floor, (err, floor)
    assert _mae(got, want32) <= AGREEMENT_PX


@pytest.mark.parametrize("name", ["ds3_gru2", "ds1", "gru1_corr2r3"])
def test_option_set_bf16_train_step_runs(name):
    """A bf16 train step at the option set: a finite float32 loss, finite
    float32 gradients at every parameter, and the context net's BatchNorm
    statistics moved (the JAX comparison of RAFT's bf16 step is
    ``test_torch_raft_bf16_train.py``'s, at the default set)."""
    from stereoformer_tpu_torch import train

    opts = OPTION_SETS[name]
    left, right = _images(seed=3, b=2, h=64, w=128)
    gt = np.full((2, 64, 128, 1), 5.0, np.float32)
    torch.manual_seed(0)
    model = get_model("RAFT_Stereo", device="cpu", dtype=torch.bfloat16,
                      **opts)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = train.Amsgrad(1e-3)
    state, m = train.make_train_step(tx, "sequence", iters=2)(
        train.TrainState.create(model, tx),
        {"img_left": _t(left), "img_right": _t(right), "gt_disp": _t(gt)})
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k
    moved = [k for k, v in model.state_dict().items()
             if k.endswith("running_mean") and not torch.equal(v, before[k])]
    assert moved and all(k.startswith("cnet.") for k in moved)


@pytest.mark.parametrize("factor", [2, 8])
def test_upsample_convex_at_option_factors(factor):
    """The convex upsample at ``downsample`` 1 and 3 (mask 36 and 576
    channels)."""
    rng = np.random.default_rng(factor)
    disp = rng.standard_normal((2, 5, 7, 1)).astype(np.float32)
    mask = rng.standard_normal((2, 5, 7, 9 * factor ** 2)).astype(np.float32)
    got = ops.upsample_convex(_t(disp), _t(mask), factor)
    want = jops.upsample_convex(jnp.asarray(disp), jnp.asarray(mask), factor)
    assert got.shape == want.shape == (2, 5 * factor, 7 * factor, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_corr_lookup_two_levels_radius_three():
    """The pyramid of 2 levels read at radius 3 (14 values a pixel), centres
    inside and beyond a row."""
    rng = np.random.default_rng(11)
    f1 = rng.standard_normal((2, 3, 19, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 3, 19, 16)).astype(np.float32)
    pyr = ops.corr_pyramid(ops.allpairs_corr1d(_t(f1), _t(f2)), 2)
    jpyr = jops.corr_pyramid(jops.allpairs_corr1d(f1, f2), 2)
    coords = rng.uniform(-6, 25, (2, 3, 19)).astype(np.float32)
    got = ops.corr_lookup(pyr, _t(coords), 3)
    want = jops.corr_lookup(jpyr, jnp.asarray(coords), 3,
                            cache=jops.corr_block_cache(jpyr, 3))
    assert got.shape == want.shape == (2, 3, 19, 14)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm,stride,features", [
    ("group", 1, 256), ("group", 2, 256), ("batch", 2, 384),
    ("instance", 1, 256)])
def test_bottleneck_block_matches_jax(norm, stride, features):
    """Train mode: the output, its gradient to x and to every parameter
    (through the bridge), and batch norm's running statistics after the
    call."""
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 12, 18, features)).astype(np.float32)
    g = rng.standard_normal((2, 12 // stride, 18 // stride, features)
                            ).astype(np.float32)
    jblock = JaxBottleneckBlock(features, norm=norm, stride=stride)
    shapes = jax.eval_shape(
        lambda a: jblock.init(jax.random.PRNGKey(0), a, train=False), x)
    variables = _seeded_variables(shapes, seed=3)
    stats = variables.get("batch_stats", {})

    def loss(params, a):
        y, upd = jblock.apply({"params": params, "batch_stats": stats}, a,
                              train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (want, upd)), (jgp, jgx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x)
    block = BottleneckBlock(features, features, norm, stride).train()
    block.load_state_dict(module_state_dict_from_jax(block, variables),
                          strict=True)
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = block(xt)
    (y * _t(g).permute(0, 3, 1, 2)).sum().backward()
    got = y.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BOTTLENECK_RTOL * np.abs(want).max())

    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)

    assert rel(xt.grad.permute(0, 2, 3, 1).numpy(),
               np.asarray(jgx)) <= BOTTLENECK_GRAD_RTOL
    want_grads = module_state_dict_from_jax(block, {"params": jgp})
    params = dict(block.named_parameters())
    assert sorted(want_grads) == sorted(params)
    for k, p in params.items():
        if (norm != "group" and k.endswith("bias")
                and not k.startswith("norm")):
            # every conv feeds a per-channel norm: its bias's gradient is 0
            # in exact arithmetic, float32 noise on both sides
            scale = NORM_FED_BIAS_ATOL * np.linalg.norm(
                want_grads[k[:-4] + "weight"].numpy())
            assert np.abs(p.grad.numpy()).max() <= scale, k
            assert np.abs(want_grads[k].numpy()).max() <= scale, k
            continue
        err = rel(p.grad.numpy(), want_grads[k].numpy())
        assert err <= BOTTLENECK_GRAD_RTOL, (k, err)
    if norm == "batch":
        new = module_state_dict_from_jax(block, {
            "params": variables["params"],
            "batch_stats": upd["batch_stats"]})
        for k, v in block.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), new[k].numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=k)


def test_bottleneck_block_bf16_matches_flax():
    """Eval in bf16 (group norm, stride 2): the repo's bf16 bound and the
    share of outputs that are not bit-equal."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 18, 256)).astype(np.float32)
    jblock = JaxBottleneckBlock(256, norm="group", stride=2,
                                dtype=jnp.bfloat16)
    shapes = jax.eval_shape(
        lambda a: jblock.init(jax.random.PRNGKey(0), a, train=False), x)
    variables = _seeded_variables(shapes, seed=4)
    want = jax.jit(lambda v, a: jblock.apply(v, a, train=False))(
        variables, jnp.asarray(x, jnp.bfloat16))
    block = BottleneckBlock(256, 256, "group", 2, dtype=torch.bfloat16).eval()
    block.load_state_dict(module_state_dict_from_jax(block, variables))
    with torch.inference_mode():
        got = block(_t(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _check(got, want, "BottleneckBlock bf16")
