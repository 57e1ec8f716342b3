"""The deformable-conv and deformable-RoI modules of the PyTorch port
(``nn/deform.py``, ``ops/deform_roi.py``) against the JAX package's, on the
CPU.

Each JAX module gets seeded variables (kernels and deformable weights at
He scale, so the offset predictors move the samples by about a pixel),
carried into the port by ``weights.module_state_dict_from_jax``; both sides
run the same seeded inputs (offsets of a few pixels, off the integers).
Values are held relative to the largest output, gradients (of the input,
the offsets, the mask and every parameter, by ``sum(out * g)`` for a
seeded g) norm-wise relative: float32 on both sides, the same bilinear
gathers, sums in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu.nn import deform as jdeform  # noqa: E402
from stereoformer_tpu.ops.deform_roi import (  # noqa: E402
    deform_psroi_pool as jax_psroi_pool,
)
from stereoformer_tpu_torch.nn import deform  # noqa: E402
from stereoformer_tpu_torch.ops import deform_psroi_pool  # noqa: E402
from stereoformer_tpu_torch.weights import module_state_dict_from_jax  # noqa: E402

# float32 gathers and sums in another order: outputs relative to the
# largest, gradients norm-wise relative
VALUE_RTOL = 1e-5
GRAD_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _fill(shapes, seed):
    """Seeded variables: kernels and deformable weights at He scale over
    their fan-in, biases 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(node, name=""):
        if hasattr(node, "items"):
            return {k: fill(v, k) for k, v in node.items()}
        shape = np.shape(node)
        if name in ("kernel", "weight"):
            std = np.sqrt(2.0 / np.prod(shape[:-1]))
            return (std * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return fill(jax.device_get(shapes))


def _init(module, *args, seed=0):
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a), *args)
    return _fill(shapes, seed)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _close(got, want, label=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=VALUE_RTOL * np.abs(want).max(),
                               err_msg=label)


def _jax_run(module, variables, args, g, extra=()):
    """JAX's output and the gradients of sum(out * g) to the parameters and
    to each of ``args`` (``extra`` follows them, not differentiated)."""
    def loss(params, *a):
        out = module.apply({"params": params}, *a, *extra)
        return jnp.sum(out * g), out

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args) + 1)), has_aux=True)(
        variables["params"], *args)
    return np.asarray(out), grads[0], [np.asarray(x) for x in grads[1:]]


def _check_param_grads(port, jgrads):
    want = module_state_dict_from_jax(port, {"params": jgrads})
    params = dict(port.named_parameters())
    assert sorted(want) == sorted(params)
    for k, p in params.items():
        assert _rel(p.grad.numpy(), want[k].numpy()) <= GRAD_RTOL, k


def _offsets(rng, B, Ho, Wo, K, scale=1.7):
    off = rng.uniform(-scale, scale, (B, Ho, Wo, K, 2)).astype(np.float32)
    return off


def _to_port_offsets(off):
    """[B, Ho, Wo, K, 2] -> the reference layout [B, 2K, Ho, Wo]."""
    B, Ho, Wo = off.shape[:3]
    return _t(off.reshape(B, Ho, Wo, -1)).permute(0, 3, 1, 2)


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("stride,dilation,mask", [
    (1, 1, True), (2, 1, True), (1, 2, True), (1, 1, False), (2, 1, False)])
def test_modulated_deform_conv_and_v1_match_jax(stride, dilation, mask):
    """``ModulatedDeformConv`` (mask given) and ``DeformConvV1`` (no mask):
    the output and the gradients of x, the offsets, the mask and the
    parameters."""
    rng = np.random.default_rng(stride + 3 * dilation)
    B, H, W, C, Co, k = 2, 9, 11, 6, 5, 3
    pad = dilation
    Ho = (H + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    Wo = (W + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    off = _offsets(rng, B, Ho, Wo, k * k)
    m = rng.uniform(0.1, 0.9, (B, Ho, Wo, k * k)).astype(np.float32)
    g = rng.standard_normal((B, Ho, Wo, Co)).astype(np.float32)
    kw = dict(kernel_size=k, stride=stride, padding=pad, dilation=dilation)
    if mask:
        jmod = jdeform.ModulatedDeformConv(Co, **kw)
        port = deform.ModulatedDeformConv(C, Co, **kw)
        args = (x, off, m)
    else:
        jmod = jdeform.DeformConvV1(Co, **kw)
        port = deform.DeformConvV1(C, Co, **kw)
        args = (x, off)
    variables = _init(jmod, *args)
    want, jgp, jga = _jax_run(jmod, variables, args, g)
    port.load_state_dict(module_state_dict_from_jax(port, variables),
                         strict=True)
    leaves = [_nchw(x), _to_port_offsets(off)] + (
        [_nchw(m)] if mask else [])
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = port(*leaves)
    _close(_nhwc(out), want)
    (out * _nchw(g)).sum().backward()
    assert _rel(_nhwc(leaves[0].grad), jga[0]) <= GRAD_RTOL
    got_off = leaves[1].grad.permute(0, 2, 3, 1).reshape(off.shape)
    assert _rel(got_off.numpy(), jga[1]) <= GRAD_RTOL
    if mask:
        assert _rel(_nhwc(leaves[2].grad), jga[2]) <= GRAD_RTOL
    _check_param_grads(port, jgp)


@pytest.mark.parametrize("stride", [1, 2])
def test_modulated_deform_normal_matches_jax(stride):
    """Offsets and mask from a conv of a second feature map (8 channels),
    the sampling and the weight on the first."""
    rng = np.random.default_rng(10 + stride)
    B, H, W, C, Cn, Co = 2, 10, 12, 6, 8, 7
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    normal = rng.standard_normal((B, H, W, Cn)).astype(np.float32)
    jmod = jdeform.ModulatedDeformNormal(Co, stride=stride)
    port = deform.ModulatedDeformNormal(C, Co, stride=stride,
                                        normal_channels=Cn)
    variables = _init(jmod, x, normal, seed=1)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    g = rng.standard_normal((B, Ho, Wo, Co)).astype(np.float32)
    want, jgp, jga = _jax_run(jmod, variables, (x, normal), g)
    port.load_state_dict(module_state_dict_from_jax(port, variables),
                         strict=True)
    leaves = [_nchw(x).requires_grad_(True),
              _nchw(normal).requires_grad_(True)]
    out = port(*leaves)
    _close(_nhwc(out), want)
    (out * _nchw(g)).sum().backward()
    for leaf, w in zip(leaves, jga):
        assert _rel(_nhwc(leaf.grad), w) <= GRAD_RTOL
    _check_param_grads(port, jgp)


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_v1_pack_matches_jax(stride):
    rng = np.random.default_rng(20 + stride)
    B, H, W, C, Co = 2, 10, 12, 6, 7
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    jmod = jdeform.DeformConvV1Pack(Co, stride=stride)
    port = deform.DeformConvV1Pack(C, Co, stride=stride)
    variables = _init(jmod, x, seed=2)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    g = rng.standard_normal((B, Ho, Wo, Co)).astype(np.float32)
    want, jgp, jga = _jax_run(jmod, variables, (x,), g)
    port.load_state_dict(module_state_dict_from_jax(port, variables),
                         strict=True)
    xt = _nchw(x).requires_grad_(True)
    out = port(xt)
    _close(_nhwc(out), want)
    (out * _nchw(g)).sum().backward()
    assert _rel(_nhwc(xt.grad), jga[0]) <= GRAD_RTOL
    _check_param_grads(port, jgp)


def test_pack_modules_start_as_plain_convs():
    """The offset predictors start at zero, as the JAX modules' do:
    ``DeformConvV1Pack`` is then the plain conv, ``ModulatedDeformNormal``
    the plain conv modulated by 0.5, and the RoI pack's last layer is 0."""
    torch.manual_seed(0)
    x = torch.randn(2, 6, 9, 11)
    pack = deform.DeformConvV1Pack(6, 5)
    normal = deform.ModulatedDeformNormal(6, 5)
    with torch.no_grad():
        plain = torch.nn.functional.conv2d(x, pack.weight, pack.bias,
                                           padding=1)
        torch.testing.assert_close(pack(x), plain, rtol=1e-5, atol=1e-5)
        half = torch.nn.functional.conv2d(x, 0.5 * normal.weight,
                                          normal.bias, padding=1)
        torch.testing.assert_close(normal(x, x), half, rtol=1e-5, atol=1e-5)
    roi = deform.DeformRoIPoolingPack(6, pooled_size=3, deform_fc_dim=16)
    assert not roi.offset_mask_fc[4].weight.any()
    assert roi.offset_mask_fc[0].weight.std() > 0


def _rois(rng, N, B, H, W, scale):
    """Boxes in image coordinates (1/``scale`` of the features), some
    reaching past the image's edges, some degenerate."""
    x1 = rng.uniform(-4, W / scale - 4, N)
    y1 = rng.uniform(-4, H / scale - 4, N)
    x2 = x1 + rng.uniform(0, W / scale / 2, N)
    y2 = y1 + rng.uniform(0, H / scale / 2, N)
    rois = np.stack([rng.integers(0, B, N).astype(np.float64), x1, y1, x2,
                     y2], 1).astype(np.float32)
    rois[0, 3], rois[0, 4] = rois[0, 1], rois[0, 2]
    return rois


@pytest.mark.parametrize("with_offsets", [False, True])
def test_deform_psroi_pool_matches_jax(with_offsets):
    rng = np.random.default_rng(30 + with_offsets)
    B, H, W, C, N, P = 2, 12, 16, 5, 6, 3
    feats = rng.standard_normal((B, H, W, C)).astype(np.float32)
    rois = _rois(rng, N, B, H, W, 0.5)
    off = (rng.standard_normal((N, P, P, 2)).astype(np.float32)
           if with_offsets else None)
    g = rng.standard_normal((N, P, P, C)).astype(np.float32)
    kw = dict(pooled_size=P, spatial_scale=0.5, trans_std=0.3,
              sample_per_part=2)

    def jloss(f, o):
        out = jax_psroi_pool(f, jnp.asarray(rois), o, **kw)
        return jnp.sum(out * g), out

    if with_offsets:
        (_, want), (gf, go) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(feats, off)
    else:
        (_, want), gf = jax.value_and_grad(
            lambda f: jloss(f, None), has_aux=True)(feats)
    ft = _t(feats).requires_grad_(True)
    ot = None if off is None else _t(off).requires_grad_(True)
    out = deform_psroi_pool(ft, _t(rois), ot, **kw)
    _close(out.detach().numpy(), want)
    (out * _t(g)).sum().backward()
    assert _rel(ft.grad.numpy(), gf) <= GRAD_RTOL
    if with_offsets:
        assert _rel(ot.grad.numpy(), go) <= GRAD_RTOL


@pytest.mark.parametrize("no_trans", [False, True])
def test_deform_roi_pooling_modules_match_jax(no_trans):
    """``DeformRoIPooling`` with offsets given, and ``DeformRoIPoolingPack``
    (the FC head's last layer seeded, so the offsets and the mask move):
    the output and the gradients of the features and the parameters."""
    rng = np.random.default_rng(40 + no_trans)
    B, H, W, C, N, P = 2, 12, 16, 4, 5, 3
    feats = rng.standard_normal((B, H, W, C)).astype(np.float32)
    rois = _t(_rois(rng, N, B, H, W, 0.25))
    off = rng.standard_normal((N, P, P, 2)).astype(np.float32)
    g = rng.standard_normal((N, P, P, C)).astype(np.float32)
    kw = dict(pooled_size=P, spatial_scale=0.25, trans_std=0.2,
              sample_per_part=2, no_trans=no_trans)

    jmod = jdeform.DeformRoIPooling(**kw)
    want = jmod.apply({}, feats, jnp.asarray(rois.numpy()), off)
    port = deform.DeformRoIPooling(**kw)
    got = port(_nchw(feats), rois, _t(off).permute(0, 3, 1, 2))
    _close(_nhwc(got), want, "DeformRoIPooling")

    jpack = jdeform.DeformRoIPoolingPack(deform_fc_dim=32, **kw)
    pack = deform.DeformRoIPoolingPack(C, deform_fc_dim=32, **kw)
    rois_j = jnp.asarray(rois.numpy())
    ft = _nchw(feats).requires_grad_(True)
    if no_trans:
        # plain pooling: the FC head is not built in JAX, not read here
        want = jpack.apply({}, feats, rois_j)
        _close(_nhwc(pack(ft, rois)), want, "DeformRoIPoolingPack")
        return
    variables = _fill(jax.eval_shape(
        lambda f: jpack.init(jax.random.PRNGKey(0), f, rois_j), feats), 3)
    want, jgp, jga = _jax_run(jpack, variables, (feats,), g, (rois_j,))
    pack.load_state_dict(module_state_dict_from_jax(pack, variables),
                         strict=True)
    out = pack(ft, rois)
    _close(_nhwc(out), want, "DeformRoIPoolingPack")
    (out * _nchw(g)).sum().backward()
    assert _rel(_nhwc(ft.grad), jga[0]) <= GRAD_RTOL
    _check_param_grads(pack, jgp)
