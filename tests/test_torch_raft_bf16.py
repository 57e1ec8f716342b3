"""The port's RAFT-Stereo in bf16 (``dtype=torch.bfloat16``) against the JAX
package in bf16, on the CPU, and the fused conv's bf16 form.

The fused conv's bf16 entry points (``ops/fused_conv.py``) take their plain
version here: float32 sums from bf16 inputs, one rounding, the prologue
rounded to bf16 before the conv, the moments of the rounded output. Each is
held against the Pallas ``conv2d_fused`` entries interpreted with bf16
inputs: within one bf16 ulp of every output; the moments within
``MOMENT_RTOL`` of the kernel's, beyond what the outputs that round to the
neighbouring bf16 (the sums' order) move them by, and within
``MOMENT_RTOL`` of float64 sums of the port's own outputs.

The modules that hold a seam run beside their Flax modules under
``jax.jit``, with ``test_torch_bf16.py``'s bounds (the repo's
``2e-2 * max|ref|`` and the share of outputs not bit-equal). A residual
block whose 3x3 convs are not routed (128 channels) is XLA's on both sides
and is held to both bounds; a routed block (64 or 96 channels) is the
kernel's bf16 form in the port and the XLA conv in JAX on the CPU, which
rounds a conv and its bias twice, so it is held to the first only. The
update block runs at sizes 2^k + 1, where its align_corners resizes are
exact.

The model: JAX's test fixture of ``test_torch_raft.py`` in bf16, the port
within ``FLOOR_FACTOR`` times JAX's own floor (one bf16 ulp changed at 0.1%
of the input), correlation at least 0.9999, and within bench.py's 0.25 px
of JAX's float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu.models.raft_stereo import (  # noqa: E402
    RAFTStereo as JaxRAFTStereo,
)
from stereoformer_tpu.nn.raft.encoders import (  # noqa: E402
    GroupNormNHWC,
    RaftResidualBlock as JaxRaftResidualBlock,
)
from stereoformer_tpu.ops.pallas.conv2d import (  # noqa: E402
    conv2d_fused as jconv,
    conv2d_fused_prologue as jconv_pro,
    conv2d_fused_prologue_stats as jconv_pro_stats,
    conv2d_fused_stats as jconv_stats,
)
from stereoformer_tpu_torch import ops  # noqa: E402
from stereoformer_tpu_torch.models import RAFTStereo  # noqa: E402
from stereoformer_tpu_torch.nn.raft import (  # noqa: E402
    GroupNorm,
    RaftResidualBlock,
)
from stereoformer_tpu_torch.weights import (  # noqa: E402
    _raft_block,
    raft_state_dict_from_jax,
)

from test_torch_bf16 import (  # noqa: E402
    AGREEMENT_PX,
    BF,
    FLOOR_FACTOR,
    ULP,
    _check,
    _f32,
    _init,
    _mae,
    _nchw,
    _run,
)
from test_torch_raft import B, H, W, _seeded_variables  # noqa: E402

# the moments' sums over H*W in another order than the interpreted
# kernel's, relative to each moment's largest magnitude
MOMENT_RTOL = 1e-5
# float32 sums of 9 C products in two orders, relative to the largest output
F32_SUM_RTOL = 2.0 ** -20
ITERS = 3


def _conv_inputs(Bn, Hn, Wn, C, Co, seed):
    rng = np.random.default_rng(seed)

    def bf(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    return {"x": bf(rng.standard_normal((Bn, Hn, Wn, C))),
            "w": bf(rng.standard_normal((3, 3, C, Co)) / np.sqrt(9 * C)),
            "b": bf(0.1 * rng.standard_normal(Co)),
            "s": rng.uniform(0.5, 1.5, (Bn, C)).astype(np.float32),
            "t": (0.5 * rng.standard_normal((Bn, C))).astype(np.float32),
            "r": bf(rng.standard_normal((Bn, Hn, Wn, Co)))}


def _port(a, k):
    t = torch.from_numpy(a[k])
    return t if k in "st" else t.to(BF)


def _jax(a, k):
    return jnp.asarray(a[k], jnp.float32 if k in "st" else jnp.bfloat16)


def _within_one_ulp(got, want):
    """One bf16 ulp of each output, and near 0, where the 9 C products
    cancel, the float32 sums' own error: F32_SUM_RTOL of the largest
    output (an output of 2e-6 from products of 0.1 is off by ~1e-7 in
    either summation order)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = ULP * 2.0 ** np.floor(np.log2(np.maximum(big, 1e-30)))
    tol = np.maximum(ulp, F32_SUM_RTOL * np.abs(want).max())
    assert (np.abs(got - want) <= tol).all()


def _close_moments(got, want, slack=0.0):
    """Within MOMENT_RTOL (of each moment and of the largest), plus
    ``slack`` [B, Co]: what the outputs that differ move the sum by."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = (MOMENT_RTOL * (np.abs(want) + np.abs(want).max())
           + np.asarray(slack, np.float64))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


# the third: RAFT's 96 -> 128 layer3 entry at downsample=0
CONV_SHAPES = [(2, 19, 24, 64, 64), (1, 12, 37, 96, 96), (1, 12, 21, 96, 128)]
CONV_IDS = ["C64-H-tail", "C96-odd-W", "C96-Co128"]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=CONV_IDS)
@pytest.mark.parametrize("relu,res", [(True, True), (False, False)],
                         ids=["res-relu", "bare"])
def test_conv2d_fused_bf16_matches_pallas(shape, relu, res):
    a = _conv_inputs(*shape, seed=10)
    r = "r" if res else None
    got = ops.conv2d_fused(*(_port(a, k) for k in "xwb"),
                           None if r is None else _port(a, r), relu)
    assert got.dtype == BF
    want = jconv(*(_jax(a, k) for k in "xwb"),
                 None if r is None else _jax(a, r), relu, 8, True)
    _within_one_ulp(got, want)


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=CONV_IDS)
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_conv2d_fused_prologue_bf16_matches_pallas(shape, relu):
    a = _conv_inputs(*shape, seed=11)
    got = ops.conv2d_fused_prologue(*(_port(a, k) for k in "xwbst"), relu)
    want = jconv_pro(*(_jax(a, k) for k in "xwbst"), relu, 8, True)
    _within_one_ulp(got, want)


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=CONV_IDS)
@pytest.mark.parametrize("prologue", [False, True], ids=["stats", "pro-stats"])
def test_conv2d_fused_bf16_moments_match_pallas(shape, prologue):
    """The float32 moments of the rounded bf16 output."""
    a = _conv_inputs(*shape, seed=12)
    keys = "xwbst" if prologue else "xwb"
    fn, jfn = ((ops.conv2d_fused_prologue_stats, jconv_pro_stats) if prologue
               else (ops.conv2d_fused_stats, jconv_stats))
    y, s1, s2 = fn(*(_port(a, k) for k in keys), False)
    jy, js1, js2 = jfn(*(_jax(a, k) for k in keys), False, 8, True)
    assert y.dtype == BF and s1.dtype == s2.dtype == torch.float32
    _within_one_ulp(y, jy)
    yp, yj = y.double().numpy(), np.asarray(jy, np.float64)
    _close_moments(s1.numpy(), js1, np.abs(yp - yj).sum((1, 2)))
    _close_moments(s2.numpy(), js2, np.abs(yp ** 2 - yj ** 2).sum((1, 2)))
    y64 = y.double()
    _close_moments(s1.numpy(), y64.sum((1, 2)).numpy())
    _close_moments(s2.numpy(), y64.square().sum((1, 2)).numpy())


def test_conv2d_fused_bf16_backward_raises():
    """The bf16 backward no longer raises (``fused_conv_backward``):
    gradients of x, w and b in bf16, each the float32 sums of the plain
    backward rounded once
    (dx the flipped conv of the bf16 cotangent, dw the plain dw, db the
    float32 sum). Against the Pallas VJPs in
    ``test_torch_bf16_train_ops.py``."""
    a = _conv_inputs(1, 5, 6, 64, 64, seed=13)
    x, w, b = (_port(a, k).requires_grad_(True) for k in "xwb")
    y = ops.conv2d_fused(x, w, b, None, False)
    gy = _port(a, "r")
    y.backward(gy)
    assert x.grad.dtype == w.grad.dtype == b.grad.dtype == BF
    w_rot = w.detach().flip((0, 1)).transpose(2, 3)
    dx = ops.conv3x3_plain(gy.float(), w_rot.float(),
                           torch.zeros(64)).to(BF)
    assert torch.equal(x.grad, dx)
    assert torch.equal(w.grad, ops.conv2d_dw_plain(x.detach().float(),
                                                   gy.float()).to(BF))
    assert torch.equal(b.grad, gy.float().sum((0, 1, 2)).to(BF))


@pytest.mark.parametrize("groups,affine", [(64, False), (8, True)],
                         ids=["instance", "group"])
def test_group_norm_bf16_arithmetic_matches_flax(groups, affine):
    """float32 moments, then the subtraction and the scaling in bf16."""
    rng = np.random.default_rng(14)
    x = jnp.asarray(3 * rng.standard_normal((2, 12, 20, 64)) + 1,
                    jnp.bfloat16)
    m = GroupNormNHWC(num_groups=groups, use_scale=affine, use_bias=affine,
                      dtype=jnp.bfloat16)
    v = _init(m, x)
    port = GroupNorm(groups, 64, affine=affine, dtype=BF)
    if affine:
        port.weight.data = torch.from_numpy(np.asarray(v["params"]["scale"]))
        port.bias.data = torch.from_numpy(np.asarray(v["params"]["bias"]))
    got = port(_nchw(x))
    assert got.dtype == BF
    _check(got, _run(m, v, x))


@pytest.mark.parametrize("cin,planes,norm,stride", [
    (128, 128, "instance", 1), (128, 128, "batch", 1),
    (96, 128, "instance", 2), (128, 128, "batch", 2),
    (64, 64, "instance", 1), (64, 96, "batch", 2)],
    ids=["128-instance", "128-batch", "s2-instance", "s2-batch",
         "routed-64-instance", "routed-96-batch"])
def test_raft_residual_block_bf16_matches_flax(cin, planes, norm, stride):
    rng = np.random.default_rng(15 + stride)
    x = jnp.asarray(rng.standard_normal((2, 10, 18, cin)), jnp.bfloat16)
    m = JaxRaftResidualBlock(planes, norm, stride, dtype=jnp.bfloat16)
    v = _init(m, x, train=False)
    sd = {}
    _raft_block(sd, "b", v["params"], v.get("batch_stats"),
                shortcut=stride != 1 or cin != planes, bn=norm == "batch")
    port = RaftResidualBlock(cin, planes, norm, stride, dtype=BF).eval()
    port.load_state_dict({k[2:]: t for k, t in sd.items()})
    got = port(_nchw(x).contiguous(memory_format=torch.channels_last))
    assert got.dtype == BF
    want = _run(m, v, x, train=False)
    routed = 64 <= planes <= 96
    if not routed:
        _check(got, want, f"{norm} {stride}")
        return
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


@pytest.fixture(scope="module")
def raft16():
    rng = np.random.default_rng(0)
    left = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    right = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    j32, j16 = JaxRAFTStereo(), JaxRAFTStereo(dtype=jnp.bfloat16)
    shapes = jax.eval_shape(
        lambda a, b: j32.init(jax.random.PRNGKey(0), a, b, iters=1,
                              train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)
    port = RAFTStereo(dtype=BF).eval()
    port.load_state_dict(raft_state_dict_from_jax(variables))
    return variables, left, right, j32, j16, port


def test_update_block_bf16_matches_flax(raft16):
    """The GRU cascade in bf16 (hidden states, gates, motion features; the
    pooling summed in bf16 as XLA sums it), the flow update and the mask
    in float32; sizes 2^k + 1, so the cross-scale resizes are exact."""
    variables, _, _, _, j16, port = raft16
    rng = np.random.default_rng(16)
    sizes = [(17, 33), (9, 17), (5, 9)]

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def bf(a):
        return jnp.asarray(a, jnp.bfloat16)

    net = [bf(np.tanh(rand(B, h, w, 128))) for h, w in sizes]
    ctx = [tuple(bf(0.5 * rand(B, h, w, 128)) for _ in range(3))
           for h, w in sizes]
    corr = rand(B, 17, 33, 36)
    flow = np.concatenate([3 * rand(B, 17, 33, 1),
                           np.zeros((B, 17, 33, 1), np.float32)], -1)
    jnet, jmask, jdelta = jax.jit(
        lambda v, n, c, co, f: j16.apply(v, n, c, co, f,
                                         method=JaxRAFTStereo.update))(
        variables, net, ctx, corr, flow)
    with torch.inference_mode():
        gnet, gmask, gdelta = port.update_block(
            [_nchw(n) for n in net], [tuple(_nchw(c) for c in cs)
                                      for cs in ctx],
            torch.from_numpy(corr).permute(0, 3, 1, 2),
            torch.from_numpy(flow).permute(0, 3, 1, 2))
    for i, (got, want) in enumerate(zip(gnet, jnet)):
        assert got.dtype == BF
        _check(got, want, f"net {i}")
    assert gmask.dtype == gdelta.dtype == torch.float32
    for got, want in ((gmask, jmask), (gdelta, jdelta)):
        got, want = _f32(got), _f32(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


def test_raft_bf16_matches_jax(raft16):
    variables, left, right, j32, j16, port = raft16

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
        out = port(torch.from_numpy(left), torch.from_numpy(right),
                   iters=ITERS, test_mode=True)
    got = out["disparities"][-1]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    got = got.numpy()
    floor = _mae(floor16, want16)
    gap = _mae(want16, want32)
    err = _mae(got, want16)
    corr = float(np.corrcoef(got.ravel(), want16.ravel())[0, 1])
    print(f"RAFT: port-JAX bf16 {err:.4f} px (correlation {corr:.6f}), "
          f"JAX floor {floor:.4f}, JAX bf16-f32 {gap:.4f}, port-JAX f32 "
          f"{_mae(got, want32):.4f}")
    assert err <= FLOOR_FACTOR * floor, (err, floor, gap)
    assert corr >= 0.9999
    assert _mae(got, want32) <= AGREEMENT_PX
