"""The refinement kernels' ops past the old kernel limits, on the CPU.

The GPU route of ``correlation_volume`` and ``local_soft_argmin`` takes
D <= 1024 volume bins and S <= 128 candidates (``ops.local_volume.D_MAX``,
``S_MAX``), as the JAX package takes any. Here, on numpy-seeded inputs:
the port's plain versions against JAX's XLA ops and the interpreted Pallas
kernels (``corr_band``, ``local_refine._forward`` / ``_backward``) at D = 50
and 96, S = 33, in value and gradient; ``LowCNN_gru(max_disp=400,
num_samples=32)`` eval against the JAX model with shared weights; the
summation order of ``csrc/local_soft_argmin.cu`` and
``csrc/local_soft_argmin_bwd.cu`` emulated in float32 (a group of 1 to 4
lanes per pixel, the softmax split over the lanes and combined by XOR shuffles,
dvol summed in s order) against the plain versions, with the card's
tolerances; and the grid of ``csrc/corr_band.cu`` (32-pixel tiles, spans
of up to 32 disparities) covering every output once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu import ops as jops  # noqa: E402
from stereoformer_tpu.models.low_cnn import LowCNN as JaxLowCNN  # noqa: E402
from stereoformer_tpu.ops.pallas import corr_band, local_refine  # noqa: E402
from stereoformer_tpu_torch import ops  # noqa: E402
from stereoformer_tpu_torch.models import LowCNN  # noqa: E402
from stereoformer_tpu_torch.ops.local_volume import D_MAX, S_MAX  # noqa: E402
from stereoformer_tpu_torch.weights import (  # noqa: E402
    lowcnn_state_dict_from_jax,
)
from test_torch_kernels import (  # noqa: E402
    LOCAL_BWD_TOL,
    LOCAL_REL_TOL,
    LOCAL_TOL,
)
from test_torch_lowcnn import _seeded_variables  # noqa: E402

# float32 sums in another order than XLA's: a few ulps of O(1) values (the
# correlation is a mean over C)
CORR_TOL = 1e-5
# the local soft-argmin's values and gradients carry candidates up to
# D + 2 px: a few ulps of the largest, relative to each output's largest
# magnitude (tests/test_torch_ops.py holds 2e-5 absolute at D = 24, ~1e-6
# of its largest gradient)
REL_TOL = 2e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _torch_vjp(fn, inputs, g):
    ts = [_t(x).requires_grad_(True) for x in inputs]
    out = fn(*ts)
    return [t.numpy() for t in torch.autograd.grad(out, ts, _t(g))]


def _jax_vjp(fn, inputs, g):
    out, vjp = jax.vjp(fn, *[jnp.asarray(x) for x in inputs])
    return [np.asarray(x) for x in vjp(jnp.asarray(g, out.dtype))]


def _close(got, want, rel):
    """|got - want| within ``rel`` of want's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def edge_candidates(rng, shape, D):
    """Uniform in [-2, D+2], a third of them set to exact integers, to the
    clip bounds 0 and D-1, and to values beyond them."""
    cands = rng.uniform(-2, D + 2, shape).astype(np.float32)
    special = np.array([0.0, D - 1.0, 5.0, 4.5, 6.0, -1.0, D, 11.0, -2.0,
                        D + 2.0], np.float32)
    pick = rng.random(shape) < 0.3
    cands[pick] = rng.choice(special, size=int(pick.sum()))
    return cands


@pytest.mark.parametrize("shape,D", [((1, 2, 40, 16), 50),
                                     ((1, 2, 120, 8), 96)],
                         ids=["D50-W<D", "D96"])
def test_correlation_volume_past_the_old_limit_matches_jax(shape, D):
    rng = np.random.default_rng(20)
    left = rng.standard_normal(shape).astype(np.float32)
    right = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape[:3] + (D,)).astype(np.float32)
    got = ops.correlation_volume(_t(left), _t(right), D).numpy()
    assert got.shape == shape[:3] + (D,)
    for want in (jops.correlation_volume(jnp.asarray(left),
                                         jnp.asarray(right), D),
                 corr_band(jnp.asarray(left), jnp.asarray(right), D, True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=CORR_TOL)
    for d in range(1, D):
        assert not got[:, :, :min(d, shape[2]), d].any()
    grads = _torch_vjp(lambda a, b: ops.correlation_volume(a, b, D),
                       (left, right), g)
    direct = ops.correlation_volume_backward(_t(left), _t(right), _t(g))
    for jfn in (lambda a, b: jops.correlation_volume(a, b, D),
                lambda a, b: corr_band(a, b, D, True)):
        want = _jax_vjp(jfn, (left, right), g)
        for a, d, w in zip(grads, direct, want):
            np.testing.assert_allclose(a, w, rtol=0, atol=CORR_TOL)
            np.testing.assert_allclose(d.numpy(), w, rtol=0, atol=CORR_TOL)


@pytest.mark.parametrize("D,S", [(50, 33), (96, 33)])
def test_local_soft_argmin_past_the_old_limits_matches_jax(D, S):
    """The plain version and its autograd against the XLA op and the
    interpreted Pallas forward; the closed-form backward the CUDA kernel is
    held to against the interpreted Pallas backward."""
    rng = np.random.default_rng(21)
    shape = (1, 3, 20)
    vol = rng.standard_normal(shape + (D,)).astype(np.float32)
    cands = edge_candidates(rng, shape + (S,), D)
    g = rng.standard_normal(shape + (1,)).astype(np.float32)
    got = ops.local_soft_argmin(_t(vol), _t(cands)).numpy()
    for want in (jops.local_soft_argmin(jnp.asarray(vol), jnp.asarray(cands)),
                 local_refine._forward(jnp.asarray(vol), jnp.asarray(cands),
                                       interpret=True)):
        _close(got, want, REL_TOL)
    grads = _torch_vjp(ops.local_soft_argmin, (vol, cands), g)
    for a, w in zip(grads, _jax_vjp(jops.local_soft_argmin, (vol, cands), g)):
        _close(a, w, REL_TOL)
    closed = ops.local_soft_argmin_backward_plain(_t(vol), _t(cands), _t(g))
    pallas = local_refine._backward(jnp.asarray(vol), jnp.asarray(cands),
                                    jnp.asarray(g), interpret=True)
    for a, w in zip(closed, pallas):
        _close(a.numpy(), w, REL_TOL)


def test_lowcnn_gru_with_a_wide_range_and_many_candidates_matches_jax():
    """LowCNN_gru(max_disp=400, num_samples=32): D = 50 bins, past the
    feature map's 32 columns, and S = 33 candidates, both past the old
    kernels' limits, at 64x256, B=2, two GRU iterations, eval."""
    rng = np.random.default_rng(0)
    left = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    right = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    kw = dict(refinement="gru", max_disp=400, num_samples=32)
    jmodel = JaxLowCNN(**kw)
    shapes = jax.eval_shape(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, iters=1,
                                 train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, iters=2,
                                                train=False))(
        variables, left, right)
    model = LowCNN(**kw).eval()
    model.load_state_dict(lowcnn_state_dict_from_jax(variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(left), torch.from_numpy(right), iters=2)
    # f32 on both sides through ~20 convs and two GRU steps, as
    # tests/test_torch_lowcnn.py: 1e-3 px
    np.testing.assert_allclose(got["disp_low"].numpy(),
                               np.asarray(want["disp_low"]), rtol=0,
                               atol=1e-3)
    assert len(got["disparities"]) == len(want["disparities"]) == 2
    for g, w in zip(got["disparities"], want["disparities"]):
        assert g.shape == (2, 64, 256, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-3)


# ---- the kernels' summation order, emulated in float32 ----

def _f32(x):
    return np.float32(x) if np.isscalar(x) else x.astype(np.float32)


def _fma(a, b, c):
    """fmaf: the product exact in float64, one rounding to float32."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _butterfly(parts, op):
    """Combine [.., G] lane values by XOR shuffles with offsets G/2, ..., 1,
    as the kernels do; every lane ends with the same value."""
    G = parts.shape[-1]
    o = G // 2
    while o:
        parts = op(parts, parts[..., np.arange(G) ^ o])
        o //= 2
    return parts[..., 0]


def _emulate(vol, cands, g, G):
    """The forward's output and the backward's (dvol, dcand), summed as the
    kernels sum them: lane j holds candidates s = j, j + G, ...; its
    re-sampled values from the two hat taps; max, sum and weighted sum
    over its candidates in s order, then over the lanes by the butterfly;
    dvol[d] the sum in s order of the terms dlocal_s * w that fall on d
    (at most two a candidate, at floor(c_s) and floor(c_s) + 1)."""
    N, D = vol.shape
    S = cands.shape[1]
    dmax = np.float32(D - 1)
    x = np.minimum(np.maximum(cands, np.float32(0)), dmax)
    f = np.floor(x)
    i0 = f.astype(np.int64)
    rows = np.arange(N)[:, None]
    one = np.float32(1)
    w0 = np.maximum(np.float32(0), one - np.abs(x - f))
    val = vol[rows, i0] * w0
    nxt = i0 + 1 < D
    w1 = np.maximum(np.float32(0), one - np.abs(x - (f + one)))
    val = np.where(nxt, _fma(vol[rows, np.minimum(i0 + 1, D - 1)], w1, val),
                   val)
    lanes = [np.arange(j, S, G) for j in range(G)]
    m = np.full((N, G), -np.inf, np.float32)
    for j, s in enumerate(lanes):
        if len(s):
            m[:, j] = val[:, s].max(1)
    m = _butterfly(m, np.maximum)
    e = np.exp(val - m[:, None]).astype(np.float32)
    psum = np.zeros((N, G), np.float32)
    pacc = np.zeros((N, G), np.float32)
    for j, s in enumerate(lanes):
        for si in s:
            psum[:, j] = psum[:, j] + e[:, si]
            pacc[:, j] = _fma(e[:, si], cands[:, si], pacc[:, j])
    total = _butterfly(psum, np.add)
    acc = _butterfly(pacc, np.add)
    out = acc / total
    inv = one / total
    mean = acc * inv
    gs = g * (e * inv[:, None])
    dl = gs * (cands - mean[:, None])
    hat = np.where(nxt & (x > f),
                   vol[rows, np.minimum(i0 + 1, D - 1)] - vol[rows, i0],
                   np.float32(0))
    cg = (np.where(cands > 0, one, np.where(cands < 0, 0, 0.5))
          * np.where(cands < dmax, one, np.where(cands > dmax, 0, 0.5)))
    dcand = _fma(dl * hat, _f32(cg), gs)
    t0, t1 = dl * w0, np.where(nxt, dl * w1, np.float32(0))
    dvol = np.zeros((N, D), np.float32)
    r = np.arange(N)
    for s in range(S):
        dvol[r, i0[:, s]] += t0[:, s]
        up = nxt[:, s]
        dvol[r[up], i0[up, s] + 1] += t1[up, s]
    return out, dvol, dcand


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D,S", [(24, 21), (50, 33), (96, 33), (256, 128)])
def test_group_split_order_holds_the_card_tolerances(D, S, G):
    """The kernels' order, with G lanes per pixel (the launch picks 1, 2 or
    4 by the pixel count), against the plain versions in float32, as the
    card holds them: at the main path's (24, 21) the absolute LOCAL_TOL and
    LOCAL_BWD_TOL; past the old limits LOCAL_REL_TOL of each output's
    largest magnitude, which grows with the candidates' range."""
    rng = np.random.default_rng(22)
    N = 96
    vol = rng.standard_normal((N, D)).astype(np.float32)
    cands = edge_candidates(rng, (N, S), D)
    g = rng.standard_normal((N, 1)).astype(np.float32)
    out, dvol, dcand = _emulate(vol, cands, g, G)
    v4, c4 = _t(vol)[None, None], _t(cands)[None, None]
    want_out = ops.local_soft_argmin_plain(v4, c4)
    want_dv, want_dc = ops.local_soft_argmin_backward_plain(
        v4, c4, _t(g)[None, None])
    pairs = ((out, want_out.reshape(N).numpy(), LOCAL_TOL),
             (dvol, want_dv[0, 0].numpy(), LOCAL_BWD_TOL),
             (dcand, want_dc[0, 0].numpy(), LOCAL_BWD_TOL))
    for got, want, tol in pairs:
        if (D, S) != (24, 21):
            tol = LOCAL_REL_TOL * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_limits_take_wide_ranges_and_fit_shared_memory():
    """max_disp up to 2048 (D = 256) and num_samples up to 127 (S = 128)
    at least; at the limits the backward's shared rows (32 pixels x (D +
    S + 2 (S | 1)) floats) fit the H100's 227 KB."""
    assert D_MAX >= 256 and S_MAX >= 128
    assert 32 * (D_MAX + S_MAX + 2 * (S_MAX | 1)) * 4 <= 227 * 1024


# ---- csrc/corr_band.cu's grid ----

TW, DT, NW, WT = 32, 8, 4, 4


def _corr_band_writes(W, D):
    """The outputs (w, d) of one image row that csrc/corr_band.cu's blocks
    write, and the R slab rows they read, from the launch's grid and the
    kernel's index arithmetic."""
    warps = min(NW, -(-D // DT))
    span = warps * DT
    tiles = -(-W // TW)
    count = np.zeros((W, D), np.int64)
    for blk in range(tiles * -(-D // span)):
        w0, dspan = (blk % tiles) * TW, (blk // tiles) * span
        rbase = w0 - dspan - (span - 1)
        for warp in range(warps):
            dw = warp * DT
            for lane in range(32):
                i, k = lane % 8, lane // 8
                j0 = WT * i + span - 1 - dw - (DT - 1)
                for a in range(WT):
                    for b in range(DT):
                        row = j0 + a - b + DT - 1
                        assert 0 <= row < TW + span - 1
                        # the slab row holds R's pixel w - d
                        assert (rbase + row
                                == w0 + WT * i + a - (dspan + dw + b))
                w, d0 = w0 + WT * i + k, dspan + dw
                if w < W:
                    for b in range(DT):
                        if d0 + b < D:
                            count[w, d0 + b] += 1
    return count


@pytest.mark.parametrize("W,D", [(120, 24), (80, 24), (10, 24), (97, 50),
                                 (33, 96), (300, 256)],
                         ids=["eval", "train", "W<D", "ragged-D50",
                              "W<D96", "D256"])
def test_corr_band_grid_writes_every_output_once(W, D):
    assert (_corr_band_writes(W, D) == 1).all()
