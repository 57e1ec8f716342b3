"""The PyTorch port's ops against their JAX counterparts, on the CPU.

Inputs come from numpy seeds and go through both sides. The two kernel
ops, ``correlation_volume`` and ``local_soft_argmin``, are also held against
the JAX package's Pallas kernels run in interpret mode, in value and in
gradient. On CPU tensors the port's kernel wrappers take their plain
versions and launch nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu import ops as jops  # noqa: E402
from stereoformer_tpu.ops.pallas import (  # noqa: E402
    corr_band,
    fused_local_soft_argmin,
    local_refine,
)
from stereoformer_tpu_torch import ops  # noqa: E402

# float32 sums in another order than XLA's: a few ulps of O(1) values
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("shape", [(2, 3, 40, 16), (1, 2, 10, 8)],
                         ids=["W>D", "W<D"])
def test_correlation_volume_matches_jax_and_pallas(shape):
    rng = np.random.default_rng(0)
    left = rng.standard_normal(shape).astype(np.float32)
    right = rng.standard_normal(shape).astype(np.float32)
    D = 24
    got = ops.correlation_volume(_t(left), _t(right), D).numpy()
    want = np.asarray(jops.correlation_volume(jnp.asarray(left),
                                              jnp.asarray(right), D))
    pallas = np.asarray(corr_band(jnp.asarray(left), jnp.asarray(right), D,
                                  True))
    assert got.shape == want.shape == shape[:3] + (D,)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
    # w < d is exactly zero
    for d in range(1, D):
        assert not got[:, :, :min(d, shape[2]), d].any()


def _edge_candidates(rng, shape):
    """Uniform in [-2, 26], with some entries set to exact integers and to
    the clip bounds 0 and D-1 = 23."""
    cands = rng.uniform(-2, 26, shape).astype(np.float32)
    special = np.array([0.0, 23.0, 5.0, 4.5, 6.0, -1.0, 24.0, 11.0, -2.0,
                        26.0], np.float32)
    pick = rng.random(shape) < 0.3
    cands[pick] = rng.choice(special, size=int(pick.sum()))
    return cands


def test_local_soft_argmin_matches_jax_and_pallas():
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((2, 4, 30, 24)).astype(np.float32)
    cands = _edge_candidates(rng, (2, 4, 30, 21))
    got = ops.local_soft_argmin(_t(vol), _t(cands)).numpy()
    want = np.asarray(jops.local_soft_argmin(jnp.asarray(vol),
                                             jnp.asarray(cands)))
    pallas = np.asarray(fused_local_soft_argmin(jnp.asarray(vol),
                                                jnp.asarray(cands), True))
    assert got.shape == want.shape == (2, 4, 30, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)


def test_resample_volume_hat_matches_jax():
    rng = np.random.default_rng(2)
    vol = rng.standard_normal((1, 3, 7, 24)).astype(np.float32)
    cands = _edge_candidates(rng, (1, 3, 7, 21))
    got = ops.resample_volume_hat(_t(vol), _t(cands)).numpy()
    want = np.asarray(jops.resample_volume(jnp.asarray(vol),
                                           jnp.asarray(cands), method="hat"))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_make_candidates_matches_jax():
    rng = np.random.default_rng(3)
    shape = (2, 5, 9, 1)
    cur = rng.uniform(0, 23, shape).astype(np.float32)
    lo = rng.uniform(0, 3, shape).astype(np.float32)
    hi = rng.uniform(0, 3, shape).astype(np.float32)
    # some ranges leave [0, D-1): lower < 0, or upper exactly at D-1
    lower, upper = cur - lo, cur + hi
    upper[0, 0, :3] = 23.0
    lower[1, 1, :3] = -0.5
    got = ops.make_candidates(_t(lower), _t(upper), _t(cur), 20, 24).numpy()
    want = np.asarray(jops.make_candidates(
        jnp.asarray(lower), jnp.asarray(upper), jnp.asarray(cur), 20, 24,
        consider_valid=True))
    assert got.shape == (2, 5, 9, 21)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # invalid pixels collapse every candidate to the current disparity
    np.testing.assert_array_equal(got[0, 0, :3], np.repeat(cur[0, 0, :3], 21, -1))
    np.testing.assert_array_equal(got[1, 1, :3], np.repeat(cur[1, 1, :3], 21, -1))


@pytest.mark.parametrize("src,dst,align", [
    ((64, 256), (8, 32), False),
    ((2, 8), (4, 16), True),
    ((5, 7), (9, 15), True),
    ((9, 15), (5, 7), False),
], ids=["down8", "up2-ac", "odd-ac", "odd-down"])
def test_resize_bilinear_matches_jax(src, dst, align):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    got = ops.resize_bilinear(_t(x), dst, align_corners=align).numpy()
    want = np.asarray(jops.resize_bilinear(jnp.asarray(x), dst,
                                           align_corners=align))
    assert got.shape == (2, *dst, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_disp_warp_matches_jax():
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 6, 20, 3)).astype(np.float32)
    # sample points x - disp both inside and beyond each border
    disp = rng.uniform(-4, 24, (2, 6, 20, 1)).astype(np.float32)
    disp[0, 0, :5, 0] = [0.0, 1.0, 2.5, 19.0, -0.25]
    warped, valid = ops.disp_warp(_t(img), _t(disp))
    want_w, want_v = jops.disp_warp(jnp.asarray(img), jnp.asarray(disp))
    np.testing.assert_allclose(warped.numpy(), np.asarray(want_w), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_v))


def test_soft_argmin_and_uncertainty_match_jax():
    rng = np.random.default_rng(6)
    vol = (3 * rng.standard_normal((2, 4, 9, 24))).astype(np.float32)
    cur = rng.uniform(0, 23, (2, 4, 9, 1)).astype(np.float32)
    got = ops.soft_argmin(_t(vol)).numpy()
    want = np.asarray(jops.soft_argmin(jnp.asarray(vol)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    prob = torch.softmax(_t(vol), dim=-1)
    got_u = ops.uncertainty_volume(prob, _t(cur)).numpy()
    want_u = np.asarray(jops.uncertainty_volume(jnp.asarray(prob.numpy()),
                                                jnp.asarray(cur)))
    np.testing.assert_allclose(got_u, want_u, rtol=1e-5, atol=TOL)


def test_upsample_convex8_matches_jax():
    rng = np.random.default_rng(7)
    disp = rng.uniform(0, 23, (2, 3, 5, 1)).astype(np.float32)
    mask = rng.standard_normal((2, 3, 5, 576)).astype(np.float32)
    got = ops.upsample_convex8(_t(disp), _t(mask)).numpy()
    want = np.asarray(jops.upsample_convex8(jnp.asarray(disp),
                                            jnp.asarray(mask)))
    assert got.shape == (2, 24, 40, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_input_padder_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1, 13, 21, 3)).astype(np.float32)
    pad = ops.InputPadder(x.shape, divisor=8)
    jpad = jops.InputPadder(x.shape, divisor=8)
    got = pad.pad(_t(x))
    want = np.asarray(jpad.pad(jnp.asarray(x)))
    assert got.shape == (1, 16, 24, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pad.unpad(got).numpy(), x)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers compute the plain version, launch no
    kernel, and stay differentiable."""
    rng = np.random.default_rng(9)
    before = (ops.correlation_volume.launches, ops.local_soft_argmin.launches)
    left = _t(rng.standard_normal((1, 2, 30, 8)).astype(np.float32))
    left.requires_grad_(True)
    right = _t(rng.standard_normal((1, 2, 30, 8)).astype(np.float32))
    vol = ops.correlation_volume(left, right, 24)
    torch.testing.assert_close(vol, ops.correlation_volume_plain(left, right, 24))
    cands = _t(_edge_candidates(rng, (1, 2, 30, 21)))
    disp = ops.local_soft_argmin(vol, cands)
    torch.testing.assert_close(disp, ops.local_soft_argmin_plain(vol, cands))
    disp.sum().backward()
    assert left.grad is not None and torch.isfinite(left.grad).all()
    assert (ops.correlation_volume.launches,
            ops.local_soft_argmin.launches) == before


# --- gradients (the training slice) --------------------------------------

def _torch_vjp(fn, inputs, g):
    """Gradients of sum(fn(*inputs) * g) with respect to each input."""
    ts = [_t(x).requires_grad_(True) for x in inputs]
    out = fn(*ts)
    return [t.numpy() for t in torch.autograd.grad(out, ts, _t(g))]


def _jax_vjp(fn, inputs, g):
    out, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in inputs])
    return [np.asarray(x) for x in vjp(jnp.asarray(g, out.dtype))]


@pytest.mark.parametrize("shape", [(2, 3, 40, 16), (1, 2, 10, 8)],
                         ids=["W>D", "W<D"])
def test_correlation_volume_gradient_matches_jax_and_pallas(shape):
    """The shift-form backward against jax.grad of the XLA op and of
    corr_band (interpret mode, whose VJP is the same shift form)."""
    rng = np.random.default_rng(10)
    left = rng.standard_normal(shape).astype(np.float32)
    right = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:3] + (24,)).astype(np.float32)
    got = _torch_vjp(lambda a, b: ops.correlation_volume(a, b, 24),
                     (left, right), g)
    want = _jax_vjp(lambda a, b: jops.correlation_volume(a, b, 24),
                    (left, right), g)
    pallas = _jax_vjp(lambda a, b: corr_band(a, b, 24, True), (left, right), g)
    direct = ops.correlation_volume_backward(_t(left), _t(right), _t(g))
    for a, w, p, d in zip(got, want, pallas, direct):
        np.testing.assert_allclose(a, w, rtol=0, atol=TOL)
        np.testing.assert_allclose(a, p, rtol=0, atol=TOL)
        np.testing.assert_allclose(d.numpy(), w, rtol=0, atol=TOL)


# gradients carry candidates up to ~26 px: a few ulps of values up to ~20
GRAD_TOL = 2e-5


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_local_soft_argmin_gradient_matches_jax(impl):
    """torch autograd of the plain version against jax.grad, with
    candidates at integers, at the clip bounds 0 and D-1 and beyond them.
    No tie mask is needed: where jnp.clip splits its gradient (0.5 at a
    bound) the hat's derivative is 0 on both sides."""
    rng = np.random.default_rng(11)
    vol = rng.standard_normal((2, 4, 30, 24)).astype(np.float32)
    cands = _edge_candidates(rng, (2, 4, 30, 21))
    g = rng.standard_normal((2, 4, 30, 1)).astype(np.float32)
    jfn = (jops.local_soft_argmin if impl == "xla" else
           lambda v, c: fused_local_soft_argmin(v, c, True))
    got = _torch_vjp(ops.local_soft_argmin, (vol, cands), g)
    want = _jax_vjp(jfn, (vol, cands), g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, rtol=0, atol=GRAD_TOL)


@pytest.mark.parametrize("shape", [(2, 4, 30), (1, 3, 7)],
                         ids=["rows", "ragged"])
def test_local_soft_argmin_backward_plain_matches_pallas(shape):
    """The closed form the CUDA backward is held to, against the Pallas
    backward kernel in interpret mode."""
    rng = np.random.default_rng(12)
    vol = rng.standard_normal(shape + (24,)).astype(np.float32)
    cands = _edge_candidates(rng, shape + (21,))
    g = rng.standard_normal(shape + (1,)).astype(np.float32)
    dv, dc = ops.local_soft_argmin_backward_plain(_t(vol), _t(cands), _t(g))
    wv, wc = local_refine._backward(jnp.asarray(vol), jnp.asarray(cands),
                                    jnp.asarray(g), interpret=True)
    np.testing.assert_allclose(dv.numpy(), np.asarray(wv), rtol=0,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(dc.numpy(), np.asarray(wc), rtol=0,
                               atol=GRAD_TOL)


def test_upsample_convex8_gradient_matches_jax():
    """torch autograd against the JAX package's hand-written VJP."""
    rng = np.random.default_rng(13)
    disp = rng.uniform(0, 23, (2, 3, 5, 1)).astype(np.float32)
    mask = rng.standard_normal((2, 3, 5, 576)).astype(np.float32)
    g = rng.standard_normal((2, 24, 40, 1)).astype(np.float32)
    got = _torch_vjp(ops.upsample_convex8, (disp, mask), g)
    want = _jax_vjp(jops.upsample_convex8, (disp, mask), g)
    # gradients up to ~90 (8x disparities, 64 sub-pixels summed): a few
    # ulps of them
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-4)


def test_disp_warp_gradient_matches_jax():
    """Gradients with respect to the image and the disparity, with sample
    points inside, at and beyond both borders (where the border clamp
    passes no gradient to the disparity)."""
    rng = np.random.default_rng(14)
    img = rng.standard_normal((2, 6, 20, 3)).astype(np.float32)
    disp = rng.uniform(-4, 24, (2, 6, 20, 1)).astype(np.float32)
    disp[0, 0, :5, 0] = [0.0, 1.0, 2.5, 19.0, -0.25]
    g = rng.standard_normal((2, 6, 20, 3)).astype(np.float32)
    got = _torch_vjp(lambda i, d: ops.disp_warp(i, d)[0], (img, disp), g)
    want = _jax_vjp(lambda i, d: jops.disp_warp(i, d)[0], (img, disp), g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, rtol=0, atol=TOL)


def test_scale_disp_matches_jax():
    rng = np.random.default_rng(15)
    disp = rng.uniform(0, 50, (2, 16, 40, 1)).astype(np.float32)
    got = ops.scale_disp(_t(disp), (24, 60)).numpy()
    want = np.asarray(jops.scale_disp(jnp.asarray(disp), (24, 60)))
    assert got.shape == (2, 24, 60, 1)
    # values up to 75 px
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
