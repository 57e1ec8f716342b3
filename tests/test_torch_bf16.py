"""The port's bf16 serving (``dtype=torch.bfloat16``) against the JAX package
in bf16, on the CPU: the LowCNN family and CrossAttentionStereo.

Each module that holds a seam of the JAX package's bf16 (a cast, a rounding,
a part kept in float32) runs beside its Flax module in bf16 on the same
seeded inputs and weights, under ``jax.jit`` as the models run. Two bounds:
the repo's bf16 bound, ``2e-2 * max|ref|`` (``tests/test_raft_stereo.py``),
and the share of outputs that are not bit-equal, ``MISMATCH_MAX``. The
convolutions sum in another order than XLA's, so a few outputs per ten
thousand round to the neighbouring bf16; a rounding point put elsewhere than
JAX puts it (a conv and its bias rounded once instead of twice, torch's
sigmoid instead of JAX's expansion, a bias add rounded where XLA keeps it in
float32) makes 10-40% of them differ.

The whole models: a bf16 forward is chaotic at the scale of its own
rounding. JAX against itself, with one bf16 ulp changed at a tenth of a
percent of the input pixels, moves the last disparity by as much as bf16
moves it from float32 (``jax_self_floor``): any summation order other than
XLA's does the same. So the port's bf16 is held to JAX's bf16 within
``FLOOR_FACTOR`` times that floor, to JAX's float32 within bench.py's
0.25 px, and its outputs must be finite and float32.

The kernels' bf16 forms: the plain bf16 ``corr_band`` against JAX's
``correlation_volume`` in bf16 and against the interpreted Pallas kernel;
the fused conv's in ``test_torch_raft_bf16.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as fnn  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu import ops as jops  # noqa: E402
from stereoformer_tpu.models.cross_attention import (  # noqa: E402
    CrossAttentionStereo as JaxCrossAttention,
)
from stereoformer_tpu.models.low_cnn import LowCNN as JaxLowCNN  # noqa: E402
from stereoformer_tpu.nn import blocks as jblocks  # noqa: E402
from stereoformer_tpu.nn.conv import Conv as JaxConv  # noqa: E402
from stereoformer_tpu.nn.gru import ConvGRU as JaxConvGRU  # noqa: E402
from stereoformer_tpu.nn.update import GRUUpdate as JaxGRUUpdate  # noqa: E402
from stereoformer_tpu.ops.pallas.corr_band import corr_band  # noqa: E402
from stereoformer_tpu_torch import kernels, ops  # noqa: E402
from stereoformer_tpu_torch.models import (  # noqa: E402
    CrossAttentionStereo,
    LowCNN,
    get_model,
)
from stereoformer_tpu_torch.nn import (  # noqa: E402
    BatchNorm2d,
    ConvGRU,
    ConvLReLU,
    FPNFusion,
    GRUUpdate,
    ResBlock,
)
from stereoformer_tpu_torch.nn.conv import Conv2d  # noqa: E402
from stereoformer_tpu_torch.weights import (  # noqa: E402
    _bn,
    _conv,
    _gru_head,
    _resblock,
    cross_attention_state_dict_from_jax,
    lowcnn_state_dict_from_jax,
)

from test_torch_lowcnn import _seeded_variables  # noqa: E402

BF = torch.bfloat16
# the repo's bf16 bound, relative to the reference's largest magnitude
BF16_RTOL = 2e-2
# the share of a module's outputs that may differ from JAX's by a rounding
# (summation order); a misplaced rounding point makes 10-40% differ
MISMATCH_MAX = 0.01
# the port's bf16 against JAX's bf16, over JAX's own floor (see above)
FLOOR_FACTOR = 1.5
# bench.py's BF16_AGREEMENT_PX: bf16 against float32
AGREEMENT_PX = 0.25
ITERS = 2
ULP = 2.0 ** -7   # one bf16 ulp, relative to the value's binade


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _nchw(x):
    """NHWC numpy -> NCHW torch bf16."""
    return _t(x).permute(0, 3, 1, 2).to(BF)


def _f32(x):
    """A torch NCHW or numpy NHWC array as NHWC float32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float()
        return (x.permute(0, 2, 3, 1) if x.dim() == 4 else x).numpy()
    return np.asarray(x, np.float32)


def _fill(tree, rng, kernel_gain=2.0):
    """Seeded values for every leaf of a Flax variable tree: kernels at He
    scale (times ``kernel_gain`` / 2), BatchNorm scale and variance in
    [0.5, 1.5], the rest 0.1 N(0, 1)."""
    def fill(node, name=""):
        if hasattr(node, "items"):
            return {k: fill(v, k) for k, v in node.items()}
        shape = np.shape(node)
        if name == "kernel":
            std = np.sqrt(kernel_gain / np.prod(shape[:-1]))
            return (std * rng.standard_normal(shape)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return fill(jax.device_get(tree))


def _init(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **kw), *args)
    return _fill(shapes, np.random.default_rng(seed))


def _check(got, want, label=""):
    """The repo's bf16 bound and the share of outputs not bit-equal."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_RTOL * np.abs(want).max())
    mismatch = float((got != want).mean())
    print(f"{label}: mismatch {mismatch:.2e}, max err "
          f"{np.abs(got - want).max() / np.abs(want).max():.2e} of max|ref|")
    assert mismatch <= MISMATCH_MAX, (label, mismatch)
    return mismatch


def _run(module, variables, *args, **kw):
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


# --- the kernel's bf16 form: the plain version ---------------------------

@pytest.mark.parametrize("shape,D", [((2, 5, 40, 64), 24), ((1, 3, 20, 32), 24),
                                     ((1, 2, 70, 16), 50)])
def test_corr_band_plain_bf16_within_one_ulp_of_jax(shape, D):
    """The plain bf16 correlation volume (float32 sums over C, one
    rounding) against JAX's ``correlation_volume`` in bf16 and the Pallas
    ``corr_band`` interpreted: within one bf16 ulp of each element."""
    rng = np.random.default_rng(D)
    left = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    right = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
    got = ops.correlation_volume(_t(np.asarray(left, np.float32)).to(BF),
                                 _t(np.asarray(right, np.float32)).to(BF), D)
    assert got.dtype == BF
    got = got.float().numpy()
    for want in (jax.jit(lambda a, b: jops.correlation_volume(a, b, D))(
                     left, right),
                 corr_band(left, right, D, True)):
        assert want.dtype == jnp.bfloat16
        want = np.asarray(want, np.float32)
        ulp = ULP * 2.0 ** np.floor(np.log2(np.maximum(np.abs(want),
                                                       1e-30)))
        assert (np.abs(got - want) <= ulp).all()


def test_corr_band_bf16_backward_raises():
    """The bf16 backward no longer raises: the card's backward
    (``correlation_volume_backward``) on a bf16 cotangent takes the shift
    sums in float32 on the widened features and rounds dleft and dright to
    bf16 once; the plain version's autograd (the CPU's) gives the same
    bits. Against the Pallas VJP in ``test_torch_bf16_train_ops.py``."""
    rng = np.random.default_rng(3)
    left, right = (_t(rng.standard_normal((1, 2, 16, 8))).to(BF)
                   for _ in range(2))
    grad = _t(rng.standard_normal((1, 2, 16, 4))).to(BF)
    dl, dr = ops.correlation_volume_backward(left, right, grad)
    assert dl.dtype == dr.dtype == BF
    want = ops.correlation_volume_backward(left.float(), right.float(),
                                           grad.float())
    assert torch.equal(dl, want[0].to(BF)) and torch.equal(dr, want[1].to(BF))
    lp, rp = left.clone().requires_grad_(True), right.clone().requires_grad_(
        True)
    ops.correlation_volume(lp, rp, 4).backward(grad)
    assert torch.equal(lp.grad, dl) and torch.equal(rp.grad, dr)


# --- modules with a seam --------------------------------------------------

def test_conv_rounds_the_conv_and_the_bias_add():
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 12, 20, 16)), jnp.bfloat16)
    m = JaxConv(24, (3, 3), padding=1, dtype=jnp.bfloat16)
    v = _init(m, x)
    port = Conv2d(16, 24, 3, padding=1, dtype=BF)
    sd = {}
    _conv(sd, "c", v["params"])
    port.load_state_dict({k[2:]: t for k, t in sd.items()})
    got = port(_nchw(x))
    assert got.dtype == BF and port.weight.dtype == torch.float32
    _check(got, _run(m, v, x))


def test_batch_norm_computes_in_float32_and_casts_once():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 6, 10, 16)), jnp.bfloat16)
    m = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                      dtype=jnp.bfloat16)
    v = _init(m, x)
    port = BatchNorm2d(16, dtype=BF).eval()
    sd = {}
    _bn(sd, "n", v["params"], v["batch_stats"])
    port.load_state_dict({k[2:]: t for k, t in sd.items()})
    got = port(_nchw(x))
    assert got.dtype == BF
    want = _run(m, v, x)
    _check(got, want)
    # torch's own bf16 batch norm is not Flax's
    assert port.running_mean.dtype == torch.float32


@pytest.mark.parametrize("cin,cout,stride", [(32, 32, 1), (16, 32, 2)])
def test_resblock_matches_flax(cin, cout, stride):
    rng = np.random.default_rng(3 + stride)
    x = jnp.asarray(rng.standard_normal((2, 12, 20, cin)), jnp.bfloat16)
    m = jblocks.ResBlock(cout, stride=stride, dtype=jnp.bfloat16)
    v = _init(m, x, seed=stride, train=False)
    port = ResBlock(cin, cout, stride=stride, dtype=BF).eval()
    sd = {}
    _resblock(sd, "r", v["params"], v["batch_stats"])
    port.load_state_dict({k[2:]: t for k, t in sd.items()})
    got = port(_nchw(x))
    assert got.dtype == BF
    _check(got, _run(m, v, x, train=False))


def test_conv_lrelu_matches_flax():
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 16, 24, 3)), jnp.bfloat16)
    m = jblocks.ConvLReLU(16, kernel_size=7, stride=2, dtype=jnp.bfloat16)
    v = _init(m, x, train=False)
    port = ConvLReLU(3, 16, 7, 2, dtype=BF)
    sd = {}
    _conv(sd, "c", v["params"]["Conv_0"])
    port.load_state_dict({"0" + k[1:]: t for k, t in sd.items()})
    _check(port(_nchw(x)), _run(m, v, x, train=False))


def test_fpn_fusion_matches_flax():
    """Sizes 2^k + 1, so that the align_corners resize weights are 0, 1/2
    and 1 and the resize is exact in float32 whatever the summation order
    (else the conv after it spreads those orders' roundings)."""
    rng = np.random.default_rng(6)
    chans = (32, 32, 16)
    feats = [jnp.asarray(rng.standard_normal(
        (2, 2 ** (i + 1) + 1, 2 ** (i + 2) + 1, c)), jnp.bfloat16)
        for i, c in enumerate(chans)]
    m = jblocks.FPNFusion(channels=chans, dtype=jnp.bfloat16)
    v = _init(m, feats, train=False)
    port = FPNFusion(chans, dtype=BF).eval()
    sd = {}
    for i in range(2):
        node = v["params"][f"ConvBnRelu_{i}"]
        _conv(sd, f"layer_list.{i}.conv", node["Conv_0"], bias=False)
        _bn(sd, f"layer_list.{i}.bn", node["BatchNorm_0"],
            v["batch_stats"][f"ConvBnRelu_{i}"]["BatchNorm_0"])
    port.load_state_dict(sd)
    got = port([_nchw(f) for f in feats])
    assert got.dtype == BF
    _check(got, _run(m, v, feats, train=False))


def test_conv_gru_matches_flax():
    """Hidden state carried in bf16 over three steps from zeros of x's
    dtype; JAX's sigmoid expansion."""
    rng = np.random.default_rng(7)
    hd = 16
    xs = [jnp.asarray(rng.standard_normal((2, 8, 12, 24)), jnp.bfloat16)
          for _ in range(3)]
    m = JaxConvGRU(hidden_dim=hd, dtype=jnp.bfloat16)
    v = _init(m, xs[0], None)
    port = ConvGRU(24, hd, dtype=BF)
    zb, g = v["params"]["conv_zb"], v["params"]["conv_g"]
    sd = {}
    _conv(sd, "conv_z", {"kernel": zb["kernel"][..., :hd],
                         "bias": zb["bias"][:hd]})
    _conv(sd, "conv_b", {"kernel": zb["kernel"][..., hd:],
                         "bias": zb["bias"][hd:]})
    _conv(sd, "conv_g", g)
    port.load_state_dict(sd)
    step = jax.jit(lambda v, x, h: m.apply(v, x, h))
    h_j, h_p = None, None
    for x in xs:
        h_j = step(v, x, h_j)
        h_p = port(_nchw(x), h_p)
        assert h_p.dtype == BF and h_j.dtype == jnp.bfloat16
        _check(h_p, h_j)
        h_p = _nchw(np.asarray(h_j, np.float32))   # each step from JAX's


def test_gru_update_step_matches_flax():
    """One GRU refinement step in bf16: guidance encoder, GRU, the offset
    and mask heads in bf16 with float32 outputs, the local soft-argmin in
    float32."""
    rng = np.random.default_rng(8)
    Bn, Hn, Wn, D, hidden = 2, 8, 16, 24, 8
    volume = rng.standard_normal((Bn, Hn, Wn, D)).astype(np.float32)
    disp = rng.uniform(2, D - 3, (Bn, Hn, Wn, 1)).astype(np.float32)
    left = rng.standard_normal((Bn, Hn, Wn, 3)).astype(np.float32)
    right = rng.standard_normal((Bn, Hn, Wn, 3)).astype(np.float32)
    prob = np.asarray(jax.nn.softmax(volume, -1))
    m = JaxGRUUpdate(hidden=hidden, num_samples=20, dtype=jnp.bfloat16)
    v = _init(m, volume, disp, left, right, None, train=False, prob=prob)
    d_j, h_j, mask_j = _run(m, v, volume, disp, left, right, None,
                            train=False, prob=prob)
    sd = {}
    _gru_head(sd, v["params"], v["batch_stats"])
    port = GRUUpdate(D, hidden, 20, dtype=BF).eval()
    port.load_state_dict({k[len("local_cost_volume."):]: t
                          for k, t in sd.items()})
    with torch.inference_mode():
        d_p, h_p, mask_p = port(_t(volume), _t(disp), _t(left), _t(right),
                                None, _t(prob))
    assert h_p.dtype == BF
    assert d_p.dtype == mask_p.dtype == torch.float32
    _check(h_p, h_j, "hidden")
    _check(mask_p.numpy(), mask_j, "mask")
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=0,
                               atol=BF16_RTOL * np.abs(d_j).max())


# --- the whole models -------------------------------------------------------

_IMAGES = {}


def _images():
    if not _IMAGES:
        rng = np.random.default_rng(0)
        _IMAGES["lr"] = tuple(rng.standard_normal((2, 64, 256, 3)).astype(
            np.float32) for _ in range(2))
    return _IMAGES["lr"]


def _mae(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).mean())


def jax_runs(jax_cls, port_cls, bridge, **kw):
    """The JAX model in float32 and bf16 on the seeded variables and
    images, the bf16 model again on the left image with one bf16 ulp
    changed at 0.1% of its values, and the port in bf16 on the bridged
    weights: the last disparity and disp_low of each."""
    left, right = _images()
    j32, j16 = jax_cls(**kw), jax_cls(dtype=jnp.bfloat16, **kw)
    shapes = jax.eval_shape(
        lambda a, b: j32.init(jax.random.PRNGKey(0), a, b, iters=1,
                              train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)

    def run(model, a):
        out = jax.jit(lambda v, a, b: model.apply(
            v, a, b, iters=ITERS, train=False))(variables, a, right)
        return (np.asarray(out["disparities"][-1]),
                np.asarray(out["disp_low"]))

    nudged = left.copy()
    pick = np.random.default_rng(9).random(left.shape) < 1e-3
    nudged[pick] *= 1 + ULP
    port = port_cls(dtype=BF, **kw).eval()
    port.load_state_dict(bridge(variables))
    with torch.inference_mode():
        out = port(_t(left), _t(right), iters=ITERS)
    assert all(d.dtype == torch.float32 for d in out["disparities"])
    assert all(torch.isfinite(d).all() for d in out["disparities"])
    got = (out["disparities"][-1].numpy(), out["disp_low"].numpy())
    return {"f32": run(j32, left), "bf16": run(j16, left),
            "bf16_nudged": run(j16, nudged), "port": got}


def _assert_within_floor(r, agreement=False):
    """The port's bf16 against JAX's bf16 within FLOOR_FACTOR times JAX's
    own floor (or 1e-3 px where the floor is below it), for the last
    disparity and disp_low; with ``agreement`` also against JAX's float32
    within bench.py's 0.25 px."""
    for k, name in enumerate(("last", "disp_low")):
        floor = _mae(r["bf16_nudged"][k], r["bf16"][k])
        gap = _mae(r["bf16"][k], r["f32"][k])
        got = _mae(r["port"][k], r["bf16"][k])
        vs_f32 = _mae(r["port"][k], r["f32"][k])
        print(f"{name}: port-JAX bf16 {got:.4f} px, JAX floor {floor:.4f}, "
              f"JAX bf16-f32 {gap:.4f}, port bf16-JAX f32 {vs_f32:.4f}")
        assert got <= FLOOR_FACTOR * max(floor, 1e-3), (name, got, floor, gap)
        if agreement:
            assert vs_f32 <= AGREEMENT_PX, (name, vs_f32)


@pytest.fixture(scope="module")
def lowcnn_gru():
    return jax_runs(JaxLowCNN, LowCNN, lowcnn_state_dict_from_jax,
                    refinement="gru")


def test_lowcnn_gru_bf16_matches_jax(lowcnn_gru):
    _assert_within_floor(lowcnn_gru, agreement=True)


@pytest.mark.parametrize("kw", [
    dict(refinement="fixed"), dict(refinement="none"),
    dict(refinement="variance"), dict(refinement="gru_feature"),
    dict(refinement="learned"), dict(refinement="learned_supervised"),
    dict(refinement="gru", cost_volume="concat", upsample="simple")],
    ids=["LowCNN", "LowCNN_simple", "LowCNN_ada", "LowCNN_gru2",
         "LowCNN_dynamic", "LowCNN_dynamic_supervised", "concat-simple"])
def test_lowcnn_family_bf16_matches_jax(kw):
    _assert_within_floor(jax_runs(JaxLowCNN, LowCNN,
                                  lowcnn_state_dict_from_jax, **kw))


def test_cross_attention_bf16_matches_jax():
    _assert_within_floor(jax_runs(JaxCrossAttention, CrossAttentionStereo,
                                  cross_attention_state_dict_from_jax))


@pytest.mark.parametrize("name", ["LowCNN_gru", "CrossAttentionStereo",
                                  "LowCNN_dynamic"])
def test_registry_builds_bf16_from_the_f32_state_dict(name):
    """bf16 and float32 models take one state dict: parameters and
    BatchNorm statistics stay float32; other dtypes raise, named."""
    m32 = get_model(name, device="cpu")
    m16 = get_model(name, device="cpu", dtype=BF)
    m16.load_state_dict(m32.state_dict(), strict=True)
    assert all(p.dtype == torch.float32 for p in m16.state_dict().values()
               if p.is_floating_point())
    with pytest.raises(NotImplementedError, match="float16"):
        get_model(name, device="cpu", dtype=torch.float16)


def test_f32_only_kernel_refuses_bf16_naming_it():
    """A bf16 tensor given to a float32-only kernel raises before any
    launch, and the error names the kernel."""
    x = torch.zeros(4, dtype=BF)
    x.device  # noqa: B018 - a CPU tensor: the device check comes first
    with pytest.raises(ValueError, match="local_soft_argmin"):
        kernels.check_inputs("local_soft_argmin", x)
    cuda_like = type("T", (), {"device": torch.device("cuda", 0),
                               "dtype": BF})()
    for name in ("local_soft_argmin", "deform_sample", "conv2d_dw",
                 "corr_band", "conv2d_fused"):
        with pytest.raises(TypeError, match=name):
            kernels.check_inputs(name, cuda_like)
    with pytest.raises(TypeError, match="corr_band_bf16"):
        kernels.check_inputs("corr_band_bf16", type(
            "T", (), {"device": torch.device("cuda", 0),
                      "dtype": torch.float32})())
