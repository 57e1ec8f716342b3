"""The port's deformable convolution against the JAX package's, on the CPU.

Ops (``stereoformer_tpu_torch/ops/deform.py``): the windowed form and
``deform_conv_fused`` in value and in the gradients of x, offsets, mask and
weight, against JAX's ``modulated_deform_conv_windowed`` and its Pallas
kernel ``deform_conv_fused`` in interpret mode; offsets beyond the window;
integer offsets (where the offset gradient is JAX's subgradient exactly);
the gather form. Modules: ``DeformConv`` and ``DeformBlock`` against the
Flax modules with bridged weights, in train and eval mode, BatchNorm
statistics included. And ``make_candidates(consider_valid=False)``.

The inputs are those of ``tests/test_deform.py::_rand_case``: B=2, 13x17,
C=8, Co=6, offsets in +-1.8 px.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu import ops as jops  # noqa: E402
from stereoformer_tpu.nn.blocks import DeformBlock as JaxDeformBlock  # noqa: E402
from stereoformer_tpu.nn.blocks import DeformConv as JaxDeformConv  # noqa: E402
from stereoformer_tpu.ops.pallas.deform_sample import (  # noqa: E402
    deform_conv_fused as jax_deform_conv_fused,
)
from stereoformer_tpu_torch import ops, weights  # noqa: E402
from stereoformer_tpu_torch.nn import DeformBlock, DeformConv  # noqa: E402

# float32 sums of 9 taps x 36 shifts x 8 channels, in another order than
# JAX's: values ~1, gradients ~1
VALUE_ATOL = 2e-5
GRAD_ATOL = 5e-5
# (padding, dilation) of the cases
CONFS = {"pad1": (1, 1), "dil2": (2, 2)}


def _rand_case(scale=1.8, seed=0, B=2, H=13, W=17, C=8, Co=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    off = (rng.rand(B, H, W, 9, 2) * 2 * scale - scale).astype(np.float32)
    mask = rng.rand(B, H, W, 9).astype(np.float32)
    wgt = (rng.randn(9 * C, Co) * 0.1).astype(np.float32)
    return x, off, mask, wgt


def _integer_case():
    """Offsets exactly 0 (as the zero-initialised offset conv gives them),
    with some taps at +-1 and at the window's edge +-2."""
    x, off, mask, wgt = _rand_case(seed=3)
    rng = np.random.RandomState(4)
    off = rng.choice(np.array([0.0, 0.0, 0.0, 1.0, -1.0, 2.0, -2.0],
                              np.float32), size=off.shape)
    return x, off, mask, wgt


def _cotangent(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_value_and_grads(fn, args, g):
    """fn(*args) and the gradients of sum(fn(*args) * g) w.r.t. every arg."""
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(d) for d in vjp(jnp.asarray(g))]


def _port_value_and_grads(fn, args, g):
    """As ``_jax_value_and_grads``; an argument the output does not depend
    on gets zeros, as in JAX."""
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    out = fn(*leaves)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [np.zeros_like(a) if t.grad is None
                                  else t.grad.numpy()
                                  for a, t in zip(args, leaves)]


def _check(got, want, value_atol=VALUE_ATOL, grad_atol=GRAD_ATOL):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=value_atol)
    for name, a, b in zip(("x", "offsets", "mask", "weight"), got[1], want[1]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=grad_atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def jax_refs():
    """conf -> case -> {"windowed": (value, grads)} from JAX for the random
    and the integer-offset cases, and "pallas" (the interpreted kernel, 8-row
    tiles: two, the second ragged) for the random case."""
    refs = {}
    for conf, (pad, dil) in CONFS.items():
        refs[conf] = {}
        for case, args in (("random", _rand_case()),
                           ("integer", _integer_case())):
            g = _cotangent(args[0].shape[:3] + (6,))

            def windowed(x, o, m, w, pad=pad, dil=dil):
                return jops.modulated_deform_conv_windowed(
                    x, o, m, w, padding=pad, dilation=dil, window=2)

            def pallas(x, o, m, w, pad=pad, dil=dil):
                return jax_deform_conv_fused(x, o, m, w, 3, pad, dil, 2, 8,
                                             True)

            refs[conf][case] = {
                "args": args, "g": g,
                "windowed": _jax_value_and_grads(windowed, args, g)}
            if case == "random":
                refs[conf][case]["pallas"] = _jax_value_and_grads(pallas,
                                                                  args, g)
    return refs


def _port_fn(impl, pad, dil):
    if impl == "plain":
        return lambda x, o, m, w: ops.modulated_deform_conv_windowed(
            x, o, m, w, padding=pad, dilation=dil, window=2)
    return lambda x, o, m, w: ops.deform_conv_fused(x, o, m, w, 3, pad, dil,
                                                    2)


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("impl", ["plain", "fused"])
@pytest.mark.parametrize("ref", ["windowed", "pallas"])
def test_windowed_matches_jax(jax_refs, conf, impl, ref):
    """The port's plain windowed form and its deform_conv_fused (the plain
    form on the CPU, its backward autograd of it) against JAX's windowed
    form and the interpreted Pallas kernel: value and all four
    gradients."""
    r = jax_refs[conf]["random"]
    got = _port_value_and_grads(_port_fn(impl, *CONFS[conf]), r["args"],
                                r["g"])
    _check(got, r[ref])


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_integer_offsets_match_jax_subgradient(jax_refs, conf, impl):
    """At integer offsets JAX's hat gives the offset a gradient of exactly
    0 (max splits the tie in half, relu passes nothing at 0); a bilinear
    backward would give v(x0 + 1) - v(x0) there. The port's must be JAX's,
    and zero wherever the offsets are 0."""
    r = jax_refs[conf]["integer"]
    got = _port_value_and_grads(_port_fn(impl, *CONFS[conf]), r["args"],
                                r["g"])
    want = r["windowed"]
    _check(got, want)
    np.testing.assert_array_equal(got[1][1], want[1][1])
    assert not got[1][1].any()


def test_clamp_splits_its_gradient_at_the_window_edge():
    """jnp.clip passes half the gradient at exactly +-R (its min and max
    split ties); the port's clamp too, where torch.clamp passes all."""
    v = np.array([-3.0, -2.0, -1.5, 0.0, 2.0, 2.5], np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.clip(a, -2, 2)))(
        jnp.asarray(v)))
    t = torch.from_numpy(v).requires_grad_(True)
    ops.deform._clamp(t, 2).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 0.5, 1.0, 1.0, 0.5, 0.0])


def test_offsets_beyond_the_window_clamp():
    """Offsets up to +-5 px: the windowed form equals the gather form fed
    offsets clipped to +-2 (JAX's, in value), and its gradients are JAX's
    windowed form's (0 for the offsets outside the window)."""
    args = _rand_case(scale=5.0)
    x, off, mask, wgt = args
    g = _cotangent(x.shape[:3] + (6,))
    fn = _port_fn("plain", 1, 1)
    got = _port_value_and_grads(fn, args, g)
    want_value = np.asarray(jops.modulated_deform_conv(
        jnp.asarray(x), jnp.clip(jnp.asarray(off), -2, 2), jnp.asarray(mask),
        jnp.asarray(wgt)))
    np.testing.assert_allclose(got[0], want_value, rtol=0, atol=VALUE_ATOL)
    _check(got, _jax_value_and_grads(
        lambda *a: jops.modulated_deform_conv_windowed(*a, window=2), args,
        g))
    outside = np.abs(off) > 2
    assert outside.any()
    assert not got[1][1][outside].any()


@pytest.mark.parametrize("stride", [1, 2])
def test_gather_form_matches_jax(stride):
    """modulated_deform_conv (bilinear gathers, unbounded offsets) against
    JAX's, value and gradients, with a bias."""
    x, off, mask, wgt = _rand_case(scale=3.0)
    if stride == 2:
        off, mask = off[:, ::2, ::2], mask[:, ::2, ::2]
    bias = np.linspace(-0.5, 0.5, 6).astype(np.float32)
    g = _cotangent(off.shape[:3] + (6,))
    args = (x, off, mask, wgt)
    want = _jax_value_and_grads(
        lambda *a: jops.modulated_deform_conv(*a, jnp.asarray(bias),
                                              stride=stride), args, g)
    got = _port_value_and_grads(
        lambda *a: ops.modulated_deform_conv(*a, torch.from_numpy(bias),
                                             stride=stride), args, g)
    _check(got, want)


def test_mask_none_matches_jax():
    x, off, _, wgt = _rand_case()
    g = _cotangent(x.shape[:3] + (6,))
    want = _jax_value_and_grads(
        lambda a, o, w: jops.modulated_deform_conv_windowed(a, o, None, w),
        (x, off, wgt), g)
    got = _port_value_and_grads(
        lambda a, o, w: ops.deform_conv_fused(a, o, None, w), (x, off, wgt),
        g)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=VALUE_ATOL)
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_ATOL)


def test_deform_conv_on_cpu_runs_the_plain_form_without_launches():
    x = torch.from_numpy(_rand_case()[0]).permute(0, 3, 1, 2)
    m = DeformConv(8, 6)
    m.load_state_dict(weights.seeded_state_dict(m))
    before = ops.deform_conv_fused.launches
    out = m(x)
    assert ops.deform_conv_fused.launches == before
    # seeded: the offset conv is zero, so the plain conv modulated by 0.5
    want = 0.5 * torch.nn.functional.conv2d(x, m.weight, m.bias * 2,
                                            padding=1)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5)


def test_deform_conv_window_needs_stride_1():
    with pytest.raises(ValueError, match="stride=1 only"):
        DeformConv(8, 6, stride=2)
    DeformConv(8, 6, stride=2, window=None)


# --- modules with bridged weights --------------------------------------------

def _seeded_tree(shapes, seed, offset_scale):
    """Seeded variables for a Flax tree: kernels at sqrt(1.25/fan_in), the
    offset conv's at ``offset_scale`` of that (offsets of ~1-3 px), BatchNorm
    scale and variance in [0.5, 1.5], means and shifts nonzero."""
    rng = np.random.default_rng(seed)

    def fill(node, name="", parent=""):
        if hasattr(node, "items"):
            return {k: fill(v, k, name) for k, v in node.items()}
        shape = node.shape
        if name in ("kernel", "weight"):
            std = np.sqrt(1.25 / np.prod(shape[:-1]))
            if parent == "offset_mask":
                std *= offset_scale
            return (std * rng.standard_normal(shape)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return fill(shapes)


def _bridge(kind, variables):
    sd = {}
    if kind == "DeformConv":
        weights._deform_conv(sd, "m", variables["params"])
    else:
        weights._resblock(sd, "m", variables["params"],
                          variables.get("batch_stats"))
    return {k[2:]: v for k, v in sd.items()}


@pytest.fixture(scope="module")
def module_runs():
    """kind -> mode -> (variables, x, g, JAX output, input and parameter
    gradients, updated batch_stats) for DeformConv(6) on C=8 and
    DeformBlock(6) on C=8 (with its shortcut), at 13x17, B=2."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 13, 17, 8)).astype(np.float32)
    g = rng.standard_normal((2, 13, 17, 6)).astype(np.float32)
    runs = {}
    for kind, module in (("DeformConv", JaxDeformConv(6)),
                         ("DeformBlock", JaxDeformBlock(6))):
        shapes = jax.eval_shape(
            lambda a: module.init(jax.random.PRNGKey(0), a, train=False)
            if kind == "DeformBlock" else module.init(jax.random.PRNGKey(0),
                                                      a), x)
        variables = _seeded_tree(shapes, seed=12, offset_scale=2.0)
        runs[kind] = {}
        for mode in ("train", "eval"):
            def f(params, xx):
                v = {**variables, "params": params}
                if kind == "DeformConv":
                    return module.apply(v, xx), {}
                if mode == "train":
                    return module.apply(v, xx, train=True,
                                        mutable=["batch_stats"])
                return module.apply(v, xx, train=False), {}

            (out, mutated), vjp = jax.vjp(f, variables["params"],
                                          jnp.asarray(x))
            dparams, dx = vjp((jnp.asarray(g), jax.tree_util.tree_map(
                jnp.zeros_like, mutated)))
            runs[kind][mode] = jax.tree_util.tree_map(
                np.asarray, (variables, out, dx, dparams, mutated))
    return x, g, runs


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("kind", ["DeformConv", "DeformBlock"])
def test_modules_match_flax(module_runs, kind, mode):
    """Output, the input's and every parameter's gradient, and (train mode)
    the BatchNorm statistics, with offsets of a few px (some beyond the
    window)."""
    x, g, runs = module_runs
    variables, want, dx, dparams, mutated = runs[kind][mode]
    m = DeformConv(8, 6) if kind == "DeformConv" else DeformBlock(8, 6)
    m.load_state_dict(_bridge(kind, variables), strict=True)
    m.train(mode == "train")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    out = m(xt).permute(0, 2, 3, 1)
    out.backward(torch.from_numpy(g))
    # train-mode BatchNorm divides by the batch's deviation: relative too
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=VALUE_ATOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), dx,
                               rtol=1e-4, atol=GRAD_ATOL)
    want_grads = _bridge(kind, {"params": dparams})
    got_grads = {k: p.grad.numpy() for k, p in m.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for k, w in want_grads.items():
        # sums over 2x13x17 pixels of products ~1
        np.testing.assert_allclose(got_grads[k], w.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    if kind == "DeformBlock" and mode == "train":
        stats = _bridge(kind, {"params": variables["params"],
                               "batch_stats": mutated["batch_stats"]})
        got = m.state_dict()
        for k in stats:
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[k].numpy(), stats[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
    # the offsets really reach past the window at some pixels
    if kind == "DeformConv":
        om = m.conv_offset_mask(xt.detach())[:, :18]
        assert (om.abs() > 2).any() and (om.abs() < 2).float().mean() > 0.5


# --- candidates ---------------------------------------------------------------

def test_make_candidates_clamped_matches_jax():
    """consider_valid=False clamps the bounds (lower to >= 0, upper to
    [0, D]) instead of collapsing the pixel: values and the gradients of
    lower, upper and cur_disp, ties at 0 and D included."""
    rng = np.random.default_rng(13)
    shape = (2, 5, 7, 1)
    lower = rng.uniform(-4, 20, shape).astype(np.float32)
    upper = lower + rng.uniform(-2, 12, shape).astype(np.float32)
    lower[0, 0, :3, 0] = [0.0, -1.0, 3.0]
    upper[0, 0, :3, 0] = [24.0, 0.0, 30.0]
    cur = rng.uniform(0, 23, shape).astype(np.float32)
    g = rng.standard_normal(shape[:3] + (21,)).astype(np.float32)
    for valid in (False, True):
        want = _jax_value_and_grads(
            lambda lo, up, c: jops.make_candidates(lo, up, c, 20, 24,
                                                   consider_valid=valid),
            (lower, upper, cur), g)
        got = _port_value_and_grads(
            lambda lo, up, c: ops.make_candidates(lo, up, c, 20, 24,
                                                  consider_valid=valid),
            (lower, upper, cur), g)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
