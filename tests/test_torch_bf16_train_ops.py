"""The bf16 backward of the port's kernel ops against the JAX package's
Pallas VJPs, on the CPU: what bf16 training runs through the kernels.

Each bf16 gradient is held within one bf16 ulp of the largest value of the
reference's (``ULP`` of its binade): both sides sum in float32 and round
once, in other orders, so an element may round to the neighbouring bf16.
The float32 gradients (the prologue's s and t) are held to the same bound.

- ``corr_band``: the VJP of the interpreted Pallas ``corr_band`` on bf16
  features (its ``_bwd``: the cotangent widened and divided by C, the
  shift sums in float32, dleft and dright each cast once), against the
  port's ``correlation_volume_backward``, the backward the card runs, and
  against autograd of the plain version, the one the CPU runs.
- ``conv2d_fused``: every entry's VJP (plain, residual + ReLU, prologue
  with and without ReLU, the moments, the prologue with the moments) of the
  interpreted Pallas kernel (``_bwd``, ``_prologue_bwd``,
  ``_stats_total_cotangent``, ``conv2d_dw_pallas``) with bf16 x, w, b and
  residual and float32 s and t, at C = Co = 64 with an H tail and at
  C = Co = 96, against the port's autograd node on the CPU (the plain dx
  conv and dw inside ``fused_conv_backward``); and the moments' total
  cotangent rounded to bf16 once, where two roundings would differ.
- ``conv2d_dw``: the plain version on bf16 x and g against
  ``conv2d_dw_pallas(...).astype(bf16)`` interpreted, as ``_dw`` casts it.

Beside them, the elementwise gradients every GRU gate runs in bf16
(``nn/bf16.py``'s sigmoid and tanh) against ``jax.vjp`` of
``jax.nn.sigmoid`` and ``jnp.tanh``: bit-equal over x in [-100, 100].
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu.ops.pallas.conv2d import (  # noqa: E402
    conv2d_fused as jconv,
    conv2d_fused_prologue as jconv_pro,
    conv2d_fused_prologue_stats as jconv_pro_stats,
    conv2d_fused_stats as jconv_stats,
)
from stereoformer_tpu.ops.pallas.corr_band import corr_band  # noqa: E402
from stereoformer_tpu.ops.pallas.dw_conv import conv2d_dw_pallas  # noqa: E402
from stereoformer_tpu_torch import ops  # noqa: E402
from stereoformer_tpu_torch.nn import bf16  # noqa: E402
from stereoformer_tpu_torch.ops.fused_conv import (  # noqa: E402
    conv3x3_fused,
    fused_conv_backward,
)

BF = torch.bfloat16
ULP = 2.0 ** -7   # one bf16 ulp, relative to the value's binade


def _bf(a):
    """numpy float32 values that bf16 holds exactly."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _within_one_ulp_of_largest(got, want, label):
    got = (got.float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, label
    assert np.isfinite(got).all(), label
    big = np.abs(want).max()
    tol = ULP * 2.0 ** np.floor(np.log2(big))
    err = np.abs(got - want).max()
    print(f"{label}: max err {err:.3e}, one ulp of the largest {tol:.3e}, "
          f"{(got != want).mean():.1e} of the values differ")
    assert err <= tol, (label, err, tol)


# --- corr_band --------------------------------------------------------------

@pytest.mark.parametrize("shape,D", [((2, 5, 40, 64), 24),
                                     ((1, 3, 70, 16), 50)])
def test_corr_band_bf16_backward_matches_pallas_vjp(shape, D):
    rng = np.random.default_rng(D)
    left, right = (_bf(rng.standard_normal(shape)) for _ in range(2))
    g = _bf(rng.standard_normal(shape[:3] + (D,)))
    _, vjp = jax.vjp(lambda a, b: corr_band(a, b, D, True),
                     jnp.asarray(left, jnp.bfloat16),
                     jnp.asarray(right, jnp.bfloat16))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    assert all(w.dtype == jnp.bfloat16 for w in want)

    lt, rt, gt = (torch.from_numpy(a).to(BF) for a in (left, right, g))
    node = ops.correlation_volume_backward(lt, rt, gt)
    lp, rp = (t.clone().requires_grad_(True) for t in (lt, rt))
    ops.correlation_volume(lp, rp, D).backward(gt)
    for got, label in ((node[:2], "node"), ((lp.grad, rp.grad), "plain")):
        for k, (gk, wk) in enumerate(zip(got, want)):
            assert gk.dtype == BF
            _within_one_ulp_of_largest(gk, wk, f"corr_band {label} d{k}")


# --- conv2d_fused ------------------------------------------------------------

SHAPES = [(2, 19, 24, 64, 64), (1, 12, 37, 96, 96)]
SHAPE_IDS = ["C64-H-tail", "C96"]
# variant -> (residual, prologue, moments, relu)
VARIANTS = {
    "bare": (False, False, False, False),
    "res-relu": (True, False, False, True),
    "prologue-linear": (False, True, False, False),
    "prologue-relu": (False, True, False, True),
    "stats": (False, False, True, False),
    "prologue-stats": (False, True, True, False),
}


def _conv_inputs(B, H, W, C, Co, seed):
    rng = np.random.default_rng(seed)
    return {
        "x": _bf(rng.standard_normal((B, H, W, C))),
        "w": _bf(rng.standard_normal((3, 3, C, Co)) / np.sqrt(9 * C)),
        "b": _bf(0.1 * rng.standard_normal(Co)),
        "r": _bf(rng.standard_normal((B, H, W, Co))),
        "s": rng.uniform(0.5, 1.5, (B, C)).astype(np.float32),
        "t": (0.5 * rng.standard_normal((B, C))).astype(np.float32),
        # the cotangents of y (bf16), S1 and S2 (float32; S2 sums squares)
        "gy": _bf(rng.standard_normal((B, H, W, Co))),
        "g1": (0.1 * rng.standard_normal((B, Co))).astype(np.float32),
        "g2": (0.01 * rng.standard_normal((B, Co))).astype(np.float32),
    }


def _names(variant):
    res, pro, _, _ = VARIANTS[variant]
    return "xwb" + ("r" if res else "") + ("st" if pro else "")


def _jax_vjp(a, variant):
    res, pro, stats, relu = VARIANTS[variant]
    names = _names(variant)

    def f(*diff):
        v = dict(zip(names, diff))
        if stats:
            fn = jconv_pro_stats if pro else jconv_stats
            extra = (v["s"], v["t"]) if pro else ()
            return fn(v["x"], v["w"], v["b"], *extra, relu, 8, True)
        if pro:
            return jconv_pro(v["x"], v["w"], v["b"], v["s"], v["t"], relu, 8,
                             True)
        return jconv(v["x"], v["w"], v["b"], v.get("r"), relu, 8, True)

    args = [jnp.asarray(a[k], jnp.float32 if k in "st" else jnp.bfloat16)
            for k in names]
    _, vjp = jax.vjp(f, *args)
    gy = jnp.asarray(a["gy"], jnp.bfloat16)
    cot = (gy, jnp.asarray(a["g1"]), jnp.asarray(a["g2"])) if stats else gy
    return dict(zip(names, vjp(cot)))


def _port_vjp(a, variant):
    res, pro, stats, relu = VARIANTS[variant]
    names = _names(variant)
    v = {k: torch.from_numpy(a[k]) for k in names}
    v = {k: (t if k in "st" else t.to(BF)).requires_grad_(True)
         for k, t in v.items()}
    out = conv3x3_fused(v["x"], v["w"], v["b"], v.get("r"), relu, v.get("s"),
                        v.get("t"), stats)
    gy = torch.from_numpy(a["gy"]).to(BF)
    if stats:
        outs, cots = out, (gy, torch.from_numpy(a["g1"]),
                           torch.from_numpy(a["g2"]))
    else:
        outs, cots = (out,), (gy,)
    grads = torch.autograd.grad(outs, [v[k] for k in names], cots)
    return dict(zip(names, grads))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_conv_bf16_vjp_matches_pallas(shape, variant):
    a = _conv_inputs(*shape, seed=20 + list(VARIANTS).index(variant))
    n = ops.conv2d_fused.bf16_launches
    got = _port_vjp(a, variant)
    assert ops.conv2d_fused.bf16_launches == n   # the CPU launches nothing
    want = _jax_vjp(a, variant)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        # JAX's dtypes: bf16 for x, w, b and the residual, float32 for s, t
        assert got[k].dtype == (torch.float32 if k in "st" else BF), k
        assert w.dtype == (jnp.float32 if k in "st" else jnp.bfloat16), k
        _within_one_ulp_of_largest(got[k], w, f"{variant} d{k}")


def test_total_cotangent_is_rounded_once():
    """g = gy + gs1 + 2 y gs2 summed in float32 and rounded to bf16 once
    (the Pallas ``_stats_total_cotangent``), read back as the residual's
    gradient (gpre); on these inputs rounding after each add differs."""
    rng = np.random.default_rng(5)
    B, H, W, C = 2, 6, 9, 64
    x = torch.from_numpy(_bf(rng.standard_normal((B, H, W, C)))).to(BF)
    w = torch.from_numpy(_bf(rng.standard_normal((3, 3, C, C)) / 24)).to(BF)
    y = torch.from_numpy(_bf(rng.standard_normal((B, H, W, C)))).to(BF)
    gy = torch.from_numpy(_bf(rng.standard_normal((B, H, W, C)))).to(BF)
    gs1, gs2 = (torch.from_numpy(rng.standard_normal((B, C)).astype(
        np.float32)) for _ in range(2))
    _, _, db, dres, _, _ = fused_conv_backward(
        x, w, y, gy, gs1, gs2, has_residual=True)
    once = (gy.float() + gs1[:, None, None, :]
            + 2.0 * y.float() * gs2[:, None, None, :]).to(BF)
    twice = ((gy + gs1[:, None, None, :].to(BF)).to(BF)
             + (2.0 * y * gs2[:, None, None, :].to(BF)).to(BF)).to(BF)
    assert dres.dtype == BF and torch.equal(dres, once)
    assert not torch.equal(once, twice)
    # db: the float32 sum of the rounded g, cast to b's dtype (bf16)
    assert db.dtype == BF
    assert torch.equal(db, once.float().sum((0, 1, 2)).to(BF))


# --- conv2d_dw --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 19, 24, 64, 64), (1, 12, 37, 96, 96)],
                         ids=SHAPE_IDS)
def test_conv2d_dw_plain_bf16_matches_pallas(shape):
    B, H, W, C, Co = shape
    rng = np.random.default_rng(C)
    x = _bf(rng.standard_normal((B, H, W, C)))
    g = _bf(rng.standard_normal((B, H, W, Co)))
    want = conv2d_dw_pallas(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(g, jnp.bfloat16), (3, 3), tile_h=8,
                            interpret=True).astype(jnp.bfloat16)
    got = ops.conv2d_dw_plain(torch.from_numpy(x).to(BF),
                              torch.from_numpy(g).to(BF))
    assert got.dtype == BF and got.shape == (3, 3, C, Co)
    _within_one_ulp_of_largest(got, np.asarray(want, np.float32).reshape(
        3, 3, C, Co), "conv2d_dw")


# --- the GRU gates' elementwise gradients -------------------------------------

def _flush_subnormals(a):
    """XLA on the CPU flushes a subnormal result to zero; torch keeps it."""
    return np.where(np.abs(a) < np.finfo(np.float32).tiny, 0.0, a)


@pytest.mark.parametrize("name", ["sigmoid", "tanh"])
def test_gate_gradients_match_jax_vjp_bit_for_bit(name):
    """The bf16 value and VJP of ``bf16.sigmoid`` and ``bf16.tanh`` equal
    JAX's (``lax.logistic``'s and ``lax.tanh``'s default rules, rounded per
    op) at every x in [-100, 100] on a 0.01 grid and at 5000 normal draws
    of scale 8: saturated gates (x > 6, where the sigmoid rounds to 1 and
    JAX's gradient is exactly 0) and x < -88.7 (where exp(-x) is inf)
    included. Values that are subnormal in float32 are compared as 0; where
    the sigmoid itself is subnormal (x in about (-88.7, -87.3)), XLA
    flushed it to 0 before its gradient read it, so JAX's gradient is 0
    and the port's is held below 2^-120."""
    rng = np.random.default_rng(7)
    x = _bf(np.concatenate([np.linspace(-100, 100, 20001),
                            8 * rng.standard_normal(5000)]))
    g = _bf(rng.standard_normal(x.shape))
    jf = {"sigmoid": jax.nn.sigmoid, "tanh": jnp.tanh}[name]
    y, vjp = jax.vjp(jf, jnp.asarray(x, jnp.bfloat16))
    (want,) = vjp(jnp.asarray(g, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16

    xt = torch.from_numpy(x).to(BF).requires_grad_(True)
    out = getattr(bf16, name)(xt)
    out.backward(torch.from_numpy(g).to(BF))
    assert out.dtype == BF and xt.grad.dtype == BF
    value = out.detach().float().numpy()
    flushed = _flush_subnormals(value) != value
    assert flushed.any() == (name == "sigmoid")
    for got, ref, what in ((out, y, "value"), (xt.grad, want, "gradient")):
        got = _flush_subnormals(got.detach().float().numpy())
        ref = _flush_subnormals(np.asarray(ref, np.float32))
        assert np.isfinite(got).all(), (name, what)
        if what == "gradient":
            assert (ref[flushed] == 0).all()
            assert (np.abs(got[flushed]) < 2.0 ** -120).all()
            got, ref = got[~flushed], ref[~flushed]
        bad = got != ref
        assert not bad.any(), (name, what, got[bad][:8], ref[bad][:8])
    if name == "sigmoid":   # rounds to 1: JAX's gradient is exactly 0
        sat = x > 6.5
        assert (xt.grad.float().numpy()[sat] == 0).all()
