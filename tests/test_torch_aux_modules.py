"""The JAX package's public modules that no model calls, in the PyTorch port,
against the JAX package, on the CPU: ``nn/aggregation.py`` (``ConvBn3D``,
``Hourglass3D``, ``cost_volume_pyramid``), ``nn/residual.py``
(``SAModule``, ``ResSubmoduleAttention`` with and without the deformable
bottleneck), ``SepConvGRU``, and the ops ``difference_volume``,
``lr_warp_error``, ``soft_argmin_with_prob``, ``gauss_blur``,
``forward_interpolate`` and ``InputPadder(mode="sintel")``.

Flax's SAME stride-2 transposed conv (``nn.conv.ConvTransposeSame``) is held
to ``flax.linen.ConvTranspose`` on its own, at even and odd sizes with a
kernel that is not symmetric and inputs whose rows and columns all differ.
Modules with BatchNorm run in train mode: the output, the gradients of the
inputs and of every parameter (``sum(out * g)`` for a seeded g), and the
running statistics after the call (Flax's momentum 0.9, the biased
variance). Values are held relative to the largest output, gradients
norm-wise relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu import nn as jnn  # noqa: E402
from stereoformer_tpu import ops as jops  # noqa: E402
from stereoformer_tpu_torch import nn, ops  # noqa: E402
from stereoformer_tpu_torch.weights import module_state_dict_from_jax  # noqa: E402

from test_torch_deform_modules import _fill, _rel  # noqa: E402

# float32 on both sides, sums in another order
VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-5
# BatchNorm statistics after one momentum-0.9 update
STATS_TOL = 1e-5
# the biases of convs whose output a train-mode BatchNorm takes, relative
# to the norm of the conv's weight gradient (test_torch_raft_train.py's)
NORM_FED_BIAS_ATOL = 1e-5
# through the 3-D hourglass's and the residual head's BatchNorms in train
# mode (each normalising by a batch variance that sums are taken of), the
# parameters' gradients
DEEP_GRAD_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _cf(x):
    """Channels-last numpy -> channels-first torch."""
    x = _t(x)
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _cl(x):
    """Channels-first torch -> channels-last numpy."""
    x = x.detach()
    return x.permute(0, *range(2, x.dim()), 1).numpy()


def _close(got, want, rtol=VALUE_RTOL, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=label)


def _train_run(module, variables, args, g, **kw):
    """JAX in train mode: the output, the gradients of sum(out * g) to the
    parameters and the args, and the updated batch statistics."""
    def loss(params, *a):
        out, upd = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, *a,
            train=True, mutable=["batch_stats"], **kw)
        return jnp.sum(out * g), (out, upd["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(args) + 1)), has_aux=True))(
        variables["params"], *args)
    return (np.asarray(out), grads[0], [np.asarray(a) for a in grads[1:]],
            stats)


def _check_params_and_stats(port, variables, jgrads, stats,
                            rtol=GRAD_RTOL, norm_fed=()):
    """Every parameter's gradient, ``norm_fed`` biases (of convs whose
    output a train-mode BatchNorm takes: 0 in exact arithmetic) against
    ``NORM_FED_BIAS_ATOL`` times their weight's gradient norm; then the
    running statistics."""
    want = module_state_dict_from_jax(port, {"params": jgrads})
    params = dict(port.named_parameters())
    assert sorted(want) == sorted(params)
    for k, p in params.items():
        g, w = p.grad.numpy(), want[k].numpy()
        if k in norm_fed:
            scale = NORM_FED_BIAS_ATOL * np.linalg.norm(
                want[k[:-4] + "weight"].numpy())
            assert np.abs(g).max() <= scale and np.abs(w).max() <= scale, k
            continue
        assert _rel(g, w) <= rtol, (k, _rel(g, w))
    moved = module_state_dict_from_jax(
        port, {"params": variables["params"], "batch_stats": stats})
    n = 0
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), moved[k].numpy(),
                                       rtol=STATS_TOL, atol=STATS_TOL,
                                       err_msg=k)
            n += 1
    assert n > 0


def _graded(*xs):
    return [x.requires_grad_(True) for x in xs]


@pytest.mark.parametrize("dims,size", [(2, (6, 10)), (2, (5, 7)),
                                       (3, (4, 6, 8)), (3, (3, 5, 7))],
                         ids=["2d-even", "2d-odd", "3d-even", "3d-odd"])
def test_conv_transpose_same_matches_flax(dims, size):
    """Flax's ``ConvTranspose(padding="SAME", strides=2)``: output s * n on
    every axis; a kernel with no symmetry (each tap its own values) and an
    input whose rows and columns all differ, so a missing flip or a shifted
    window shows; value and gradients."""
    rng = np.random.default_rng(dims * 10 + size[0])
    Ci, Co = 3, 4
    x = (rng.standard_normal((2, *size, Ci))
         + np.arange(np.prod(size)).reshape(1, *size, 1) / 10.0
         ).astype(np.float32)
    kernel = (np.arange(3 ** dims * Ci * Co).reshape((3,) * dims + (Ci, Co))
              / 50.0 + 0.1 * rng.standard_normal((3,) * dims + (Ci, Co))
              ).astype(np.float32)
    jmod = fnn.ConvTranspose(Co, (3,) * dims, strides=(2,) * dims,
                             padding="SAME", use_bias=False)
    g = rng.standard_normal((2, *(2 * n for n in size), Co)).astype(np.float32)

    def loss(k, a):
        out = jmod.apply({"params": {"kernel": k}}, a)
        return jnp.sum(out * g), out

    (_, want), (gk, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(kernel, x)
    assert want.shape == (2, *(2 * n for n in size), Co)
    port = nn.ConvTransposeSame(Ci, Co, dims=dims)
    sd = {}
    from stereoformer_tpu_torch.weights import _conv_transpose
    _conv_transpose(sd, "w", {"kernel": kernel})
    with torch.no_grad():
        port.weight.copy_(sd["w.weight"])
    (xt,) = _graded(_cf(x))
    out = port(xt)
    _close(_cl(out), want)
    (out * _cf(g)).sum().backward()
    assert _rel(_cl(xt.grad), gx) <= GRAD_RTOL
    back = {}
    _conv_transpose(back, "w", {"kernel": np.asarray(gk)})
    assert _rel(port.weight.grad.numpy(), back["w.weight"].numpy()) <= GRAD_RTOL


@pytest.mark.parametrize("stride,relu", [(1, True), (2, False)])
def test_conv_bn_3d_matches_jax(stride, relu):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 6, 8, 10, 5)).astype(np.float32)
    jmod = jnn.ConvBn3D(7, stride=stride, relu=relu)
    variables = _fill(jax.eval_shape(
        lambda a: jmod.init(jax.random.PRNGKey(0), a, train=False), x), 1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    out_shape = (2, *(-(-n // stride) for n in (6, 8, 10)), 7)
    g = rng.standard_normal(out_shape).astype(np.float32)
    want, jgp, (jgx,), stats = _train_run(jmod, variables, (x,), g)
    port = nn.ConvBn3D(5, 7, stride=stride, relu=relu).train()
    port.load_state_dict(module_state_dict_from_jax(port, variables),
                         strict=True)
    (xt,) = _graded(_cf(x))
    out = port(xt)
    _close(_cl(out), want)
    (out * _cf(g)).sum().backward()
    assert _rel(_cl(xt.grad), jgx) <= GRAD_RTOL
    _check_params_and_stats(port, variables, jgp, stats)
    # eval, with the statistics the train-mode call left
    port.eval()
    with torch.no_grad():
        got = port(_cf(x))
    _close(_cl(got), jmod.apply(
        {"params": variables["params"], "batch_stats": stats}, x,
        train=False))


def test_batch_norm_float64_computes_in_float64():
    """A float64 volume through the Flax BatchNorm (a float64 reference of
    the 3-D modules): normalised in float64 in train mode, its running
    statistics moved in float64, and within float32 rounding of the
    float32 norm."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(3 + 2 * rng.standard_normal((2, 5, 4, 6, 7)))
    bn64 = nn.BatchNorm2d(5).double().train()
    bn32 = nn.BatchNorm2d(5).train()
    y64, y32 = bn64(x), bn32(x.float())
    assert y64.dtype == torch.float64 and y32.dtype == torch.float32
    want = (x - x.mean((0, 2, 3, 4), keepdim=True)) / torch.sqrt(
        x.var((0, 2, 3, 4), unbiased=False, keepdim=True) + 1e-5)
    torch.testing.assert_close(y64, want, rtol=0, atol=1e-12)
    torch.testing.assert_close(y32.double(), want, rtol=0, atol=1e-5)
    torch.testing.assert_close(
        bn64.running_var, 0.9 + 0.1 * x.var((0, 2, 3, 4), unbiased=False),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize("size", [(4, 8, 12), (8, 12, 4)])
def test_hourglass_3d_matches_jax(size):
    """Train mode (two stride-2 stages down, two SAME transposed convs up)
    and eval."""
    rng = np.random.default_rng(size[0])
    f = 4
    x = rng.standard_normal((2, *size, f)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jmod = jnn.Hourglass3D(f)
    variables = _fill(jax.eval_shape(
        lambda a: jmod.init(jax.random.PRNGKey(0), a, train=False), x), 2)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    want, jgp, (jgx,), stats = _train_run(jmod, variables, (x,), g)
    port = nn.Hourglass3D(f).train()
    port.load_state_dict(module_state_dict_from_jax(port, variables),
                         strict=True)
    (xt,) = _graded(_cf(x))
    out = port(xt)
    _close(_cl(out), want)
    (out * _cf(g)).sum().backward()
    assert _rel(_cl(xt.grad), jgx) <= DEEP_GRAD_RTOL
    _check_params_and_stats(port, variables, jgp, stats, DEEP_GRAD_RTOL)
    # eval, with the statistics the train-mode call left
    port.eval()
    with torch.no_grad():
        got = port(_cf(x))
    _close(_cl(got), jmod.apply(
        {"params": variables["params"], "batch_stats": stats}, x,
        train=False))


@pytest.mark.parametrize("mode", ["correlation", "concat", "difference"])
def test_cost_volume_pyramid_matches_jax(mode):
    rng = np.random.default_rng(3)
    lefts = [rng.standard_normal((2, 8 // 2 ** i, 24 // 2 ** i, 6)
                                 ).astype(np.float32) for i in range(3)]
    rights = [rng.standard_normal(a.shape).astype(np.float32) for a in lefts]
    want = jnn.cost_volume_pyramid(lefts, rights, 12, mode)
    got = nn.cost_volume_pyramid([_t(a) for a in lefts],
                                 [_t(a) for a in rights], 12, mode)
    assert [w.shape[3] for w in want] == [12, 6, 3]
    for gv, wv in zip(got, want):
        _close(gv.numpy(), wv)
    with pytest.raises(ValueError):
        nn.cost_volume_pyramid(lefts, rights, 12, "gwc")


def test_difference_volume_matches_jax():
    """Value and gradients, with D past W (columns w < d zero)."""
    rng = np.random.default_rng(4)
    left = rng.standard_normal((2, 3, 7, 5)).astype(np.float32)
    right = rng.standard_normal((2, 3, 7, 5)).astype(np.float32)
    g = rng.standard_normal((2, 3, 7, 9, 5)).astype(np.float32)
    (_, want), (gl, gr) = jax.value_and_grad(
        lambda a, b: (jnp.sum(jops.difference_volume(a, b, 9) * g),
                      jops.difference_volume(a, b, 9)),
        argnums=(0, 1), has_aux=True)(left, right)
    lt, rt = _graded(_t(left), _t(right))
    out = ops.difference_volume(lt, rt, 9)
    _close(out.detach().numpy(), want)
    assert not out[:, :, 2, 3:].any()
    (out * _t(g)).sum().backward()
    assert _rel(lt.grad.numpy(), gl) <= GRAD_RTOL
    assert _rel(rt.grad.numpy(), gr) <= GRAD_RTOL


def test_sam_module_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 9, 10)).astype(np.float32)
    g = rng.standard_normal((2, 6, 9, 1)).astype(np.float32)
    jmod = jnn.SAModule()
    variables = _fill(jax.eval_shape(
        lambda a: jmod.init(jax.random.PRNGKey(0), a, train=False), x), 3)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    want, jgp, (jgx,), stats = _train_run(jmod, variables, (x,), g)
    port = nn.SAModule(10).train()
    port.load_state_dict(module_state_dict_from_jax(port, variables),
                         strict=True)
    (xt,) = _graded(_cf(x))
    out = port(xt)
    _close(_cl(out), want)
    (out * _cf(g)).sum().backward()
    assert _rel(_cl(xt.grad), jgx) <= GRAD_RTOL
    _check_params_and_stats(port, variables, jgp, stats, DEEP_GRAD_RTOL)


@pytest.mark.parametrize("deform,scale,img,disp_hw", [
    (False, 2, (48, 64), (12, 16)),
    (True, 2, (48, 64), (12, 16)),
    (False, 1, (40, 56), (20, 28)),
    (True, 2, (44, 60), (8, 12))],
    ids=["plain", "deform", "scale1", "deform-not-pow2"])
def test_res_submodule_attention_matches_jax(deform, scale, img, disp_hw):
    """Train mode, in value and in the gradients of the four inputs and
    every parameter, and the BatchNorm statistics. The last case pools
    44x60 by 4 to 11x15, which the head resizes to the disparity's 8x12
    (its guard for sizes that are not powers of two), with the factor
    44 // 8 = 5; the deformable bottleneck's offset conv is seeded, so its
    offsets and mask move."""
    rng = np.random.default_rng(6 + deform)
    B, C, f = 2, 6, 8
    H, W = img
    h, w = disp_hw
    left = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    right = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    disp = rng.uniform(0.5, 6.0, (B, h, w, 1)).astype(np.float32)
    feat = rng.standard_normal((B, h, w, C)).astype(np.float32)
    g = rng.standard_normal((B, h, w, 1)).astype(np.float32)
    jmod = jnn.ResSubmoduleAttention(scale, out_planes=f, deform=deform)
    args = (left, right, disp, feat)
    variables = _fill(jax.eval_shape(
        lambda *a: jmod.init(jax.random.PRNGKey(0), *a, train=False),
        *args), 7)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.abs(a) + 0.5, variables["batch_stats"])
    want, jgp, jga, stats = _train_run(jmod, variables, args, g)
    port = nn.ResSubmoduleAttention(scale, C, out_planes=f,
                                    deform=deform).train()
    port.load_state_dict(module_state_dict_from_jax(port, variables),
                         strict=True)
    leaves = _graded(*(_t(a) for a in args))
    out = port(*leaves)
    assert out.shape == (B, h, w, 1)
    _close(out.detach().numpy(), want)
    (out * _t(g)).sum().backward()
    for leaf, jg in zip(leaves, jga):
        assert _rel(leaf.grad.numpy(), jg) <= DEEP_GRAD_RTOL
    _check_params_and_stats(port, variables, jgp, stats, DEEP_GRAD_RTOL,
                            norm_fed=("conv4.0.bias",))


def test_sep_conv_gru_matches_jax():
    """The 1x5 then 5x1 gated updates; the fused z/r convs split."""
    rng = np.random.default_rng(8)
    hd, xd = 8, 12
    h = np.tanh(rng.standard_normal((2, 7, 11, hd))).astype(np.float32)
    x = rng.standard_normal((2, 7, 11, xd)).astype(np.float32)
    g = rng.standard_normal(h.shape).astype(np.float32)
    jmod = jnn.SepConvGRU(hd)
    variables = _fill(jax.eval_shape(
        lambda a, b: jmod.init(jax.random.PRNGKey(0), a, b), h, x), 9)

    def loss(p, a, b):
        out = jmod.apply({"params": p}, a, b)
        return jnp.sum(out * g), out

    (_, want), (gp, gh, gx) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(variables["params"], h, x)
    port = nn.SepConvGRU(hd, xd)
    port.load_state_dict(module_state_dict_from_jax(port, variables),
                         strict=True)
    ht, xt = _graded(_cf(h), _cf(x))
    out = port(ht, xt)
    _close(_cl(out), want)
    (out * _cf(g)).sum().backward()
    assert _rel(_cl(ht.grad), gh) <= GRAD_RTOL
    assert _rel(_cl(xt.grad), gx) <= GRAD_RTOL
    want_g = module_state_dict_from_jax(port, {"params": gp})
    for k, p in port.named_parameters():
        assert _rel(p.grad.numpy(), want_g[k].numpy()) <= GRAD_RTOL, k


@pytest.mark.parametrize("img_w", [24, 48])
def test_lr_warp_error_matches_jax(img_w):
    """At the disparity's width, and with images twice as wide (resized
    first)."""
    rng = np.random.default_rng(img_w)
    B, h, w = 2, 6, 24
    H = h * img_w // w
    left = rng.standard_normal((B, H, img_w, 3)).astype(np.float32)
    right = rng.standard_normal((B, H, img_w, 3)).astype(np.float32)
    disp = rng.uniform(0.3, 9.7, (B, h, w, 1)).astype(np.float32)
    g = rng.standard_normal((B, h, w, 3)).astype(np.float32)
    (_, want), grads = jax.value_and_grad(
        lambda a, d, b: (jnp.sum(jops.lr_warp_error(a, d, b) * g),
                         jops.lr_warp_error(a, d, b)),
        argnums=(0, 1, 2), has_aux=True)(left, disp, right)
    leaves = _graded(_t(left), _t(disp), _t(right))
    out = ops.lr_warp_error(*leaves)
    _close(out.detach().numpy(), want)
    (out * _t(g)).sum().backward()
    for leaf, jg in zip(leaves, grads):
        assert _rel(leaf.grad.numpy(), jg) <= GRAD_RTOL


@pytest.mark.parametrize("match_similarity", [True, False])
def test_soft_argmin_with_prob_matches_jax(match_similarity):
    rng = np.random.default_rng(9)
    vol = (3 * rng.standard_normal((2, 4, 5, 24))).astype(np.float32)
    gd = rng.standard_normal((2, 4, 5)).astype(np.float32)
    gp = rng.standard_normal(vol.shape).astype(np.float32)

    def loss(v):
        d, p = jops.soft_argmin_with_prob(v, match_similarity)
        return jnp.sum(d * gd) + jnp.sum(p * gp), (d, p)

    (_, (wd, wp)), wg = jax.value_and_grad(loss, has_aux=True)(vol)
    (vt,) = _graded(_t(vol))
    d, p = ops.soft_argmin_with_prob(vt, match_similarity)
    _close(d.detach().numpy(), wd)
    _close(p.detach().numpy(), wp)
    ((d * _t(gd)).sum() + (p * _t(gp)).sum()).backward()
    assert _rel(vt.grad.numpy(), wg) <= GRAD_RTOL
    torch.testing.assert_close(ops.soft_argmin(vt.detach(), match_similarity),
                               d.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("kernel_size,sigma", [(5, 1.0), (3, 0.7), (7, 2.0)])
def test_gauss_blur_matches_jax(kernel_size, sigma):
    """Depthwise and separable: each channel blurred alone, zero padding;
    value and the input's gradient."""
    rng = np.random.default_rng(kernel_size)
    x = rng.standard_normal((2, 9, 13, 3)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    (_, want), gx = jax.value_and_grad(
        lambda a: (jnp.sum(jops.gauss_blur(a, kernel_size, sigma) * g),
                   jops.gauss_blur(a, kernel_size, sigma)), has_aux=True)(x)
    (xt,) = _graded(_t(x))
    out = ops.gauss_blur(xt, kernel_size, sigma)
    _close(out.detach().numpy(), want)
    (out * _t(g)).sum().backward()
    assert _rel(xt.grad.numpy(), gx) <= GRAD_RTOL
    # one channel alone gives the same blur
    one = ops.gauss_blur(_t(x[..., 1:2]), kernel_size, sigma)
    _close(one.numpy(), np.asarray(want)[..., 1:2])


def test_forward_interpolate_matches_jax():
    """Splats, collisions averaged, targets off the image dropped: equal to
    the JAX package's numpy."""
    rng = np.random.default_rng(10)
    flow = (4 * rng.standard_normal((15, 21, 2))).astype(np.float32)
    flow[0, 0] = [100.0, 0.0]
    flow[1, :3] = [[1.0, 0.0], [0.0, 0.0], [-1.0, 0.0]]
    got = ops.forward_interpolate(flow)
    want = jops.forward_interpolate(flow)
    assert got.dtype == want.dtype and got.shape == (15, 21, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["sintel", "default"])
@pytest.mark.parametrize("shape", [(1, 37, 45, 3), (2, 40, 48, 1),
                                   (1, 33, 64, 2)])
def test_input_padder_modes_match_jax(mode, shape):
    rng = np.random.default_rng(shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    jp = jops.InputPadder(x.shape, mode=mode)
    tp = ops.InputPadder(x.shape, mode=mode)
    assert tp._pad == jp._pad
    want = jp.pad(x)
    got = tp.pad(_t(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[1] % 8 == 0 and got.shape[2] % 8 == 0
    np.testing.assert_array_equal(tp.unpad(got).numpy(), x)
    np.testing.assert_array_equal(tp.unpad(got).numpy(),
                                  jp.unpad(jnp.asarray(want)))
