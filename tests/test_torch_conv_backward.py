"""The port's backward of the fused stride-1 conv (``ops/fused_conv.py::
fused_conv_backward``) and its weight gradient (``ops/dw_conv.py``) against
the JAX package's Pallas VJPs, on the CPU.

Each variant's gradients of x, w, b, the residual, s and t, from a seeded
scalar loss that uses y and both moments, are held against two references:
``jax.grad`` of the Pallas entry point in interpret mode with ``tile_h=8``
(its ``_bwd``, ``_prologue_bwd``, the moments' fold and ``conv2d_dw_pallas``,
interpreted), and torch autograd of the port's plain version
``conv3x3_plain``. On the CPU the port's fused op is the same autograd node
as on the card, with the plain versions of the dx conv and the dw kernel
inside. The CUDA kernels are held against the plain versions in
``tests/test_torch_kernels.py``.
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
from stereoformer_tpu.ops.pallas.dw_conv import conv2d_dw_pallas  # noqa: E402
from stereoformer_tpu_torch import ops  # noqa: E402

# Gradients, norm-wise relative to each reference: float32 sums of 9 C (dx)
# and B H W (dw, db, ds, dt) products in other orders than the interpreted
# kernels' or autograd's (measured up to 6.6e-7 against either on these
# inputs)
GRAD_RTOL = 2e-6
# and elementwise, relative to each gradient's largest magnitude (measured
# up to 1.1e-6)
GRAD_ATOL = 5e-6
# dw over B H W = 456 products per element, float32 in other orders
DW_RTOL = 1e-5

# the third: RAFT's 64 -> 96 layer2 entry at downsample 1 and 0 (C != Co);
# the fourth: its 96 -> 128 layer3 entry at downsample=0
SHAPES = [(2, 19, 24, 64, 64), (1, 12, 37, 96, 96), (1, 11, 21, 64, 96),
          (1, 12, 21, 96, 128)]
SHAPE_IDS = ["C64-H-tail", "C96-odd-W", "C64-Co96", "C96-Co128"]
# variant -> (residual, prologue, moments, relu)
VARIANTS = {
    "bare": (False, False, False, False),
    "res-relu": (True, False, False, True),
    "prologue-linear": (False, True, False, False),
    "prologue-relu": (False, True, False, True),
    "stats": (False, False, True, False),
    "prologue-stats": (False, True, True, False),
}


def _inputs(B, H, W, C, Co, seed):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((B, H, W, C)).astype(np.float32),
        "w": (rng.standard_normal((3, 3, C, Co)) / np.sqrt(9 * C))
        .astype(np.float32),
        "b": (0.1 * rng.standard_normal(Co)).astype(np.float32),
        "r": rng.standard_normal((B, H, W, Co)).astype(np.float32),
        "s": rng.uniform(0.5, 1.5, (B, C)).astype(np.float32),
        "t": (0.5 * rng.standard_normal((B, C))).astype(np.float32),
        # the loss's weights of y, S1 and S2 (S2 sums H W squares: smaller)
        "cy": rng.standard_normal((B, H, W, Co)).astype(np.float32),
        "c1": (0.1 * rng.standard_normal((B, Co))).astype(np.float32),
        "c2": (0.01 * rng.standard_normal((B, Co))).astype(np.float32),
    }


def _args(variant):
    res, pro, _, _ = VARIANTS[variant]
    return "xwb" + ("r" if res else "") + ("st" if pro else "")


def _jax_grads(a, variant):
    res, pro, stats, relu = VARIANTS[variant]
    names = _args(variant)

    def loss(*diff):
        v = dict(zip(names, diff))
        if stats:
            fn = jconv_pro_stats if pro else jconv_stats
            extra = (v["s"], v["t"]) if pro else ()
            y, s1, s2 = fn(v["x"], v["w"], v["b"], *extra, relu, 8, True)
            return (jnp.sum(y * a["cy"]) + jnp.sum(s1 * a["c1"])
                    + jnp.sum(s2 * a["c2"]))
        if pro:
            y = jconv_pro(v["x"], v["w"], v["b"], v["s"], v["t"], relu, 8,
                          True)
        else:
            y = jconv(v["x"], v["w"], v["b"], v.get("r"), relu, 8, True)
        return jnp.sum(y * a["cy"])

    grads = jax.grad(loss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(a[k]) for k in names))
    return {k: np.asarray(g) for k, g in zip(names, grads)}


def _torch_grads(a, variant, fn):
    res, pro, stats, relu = VARIANTS[variant]
    names = _args(variant)
    v = {k: torch.from_numpy(a[k]).requires_grad_(True) for k in names}
    out = fn(v["x"], v["w"], v["b"], v.get("r"), relu, v.get("s"),
             v.get("t"), stats)
    if stats:
        y, s1, s2 = out
        loss = ((y * torch.from_numpy(a["cy"])).sum()
                + (s1 * torch.from_numpy(a["c1"])).sum()
                + (s2 * torch.from_numpy(a["c2"])).sum())
    else:
        loss = (out * torch.from_numpy(a["cy"])).sum()
    grads = torch.autograd.grad(loss, [v[k] for k in names])
    return {k: g.numpy() for k, g in zip(names, grads)}


def _close(got, want, label):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (label, k)
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (label, k, err)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=f"{label} d{k}")


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_conv_backward_matches_pallas_vjp(shape, variant):
    a = _inputs(*shape, seed=10 + list(VARIANTS).index(variant))
    n = ops.conv2d_fused.launches
    got = _torch_grads(a, variant, ops.fused_conv.conv3x3_fused)
    assert ops.conv2d_fused.launches == n   # the CPU launches nothing
    _close(got, _jax_grads(a, variant), "vs jax.grad of the Pallas VJP")
    _close(got, _torch_grads(a, variant, ops.conv3x3_plain),
           "vs autograd of conv3x3_plain")


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_conv2d_dw_plain_matches_pallas(shape):
    """The tap formulation against the interpreted Pallas dw kernel with
    ``tile_h=8``: H = 19 leaves a tail of 3 rows, H = 12 one of 4."""
    B, H, W, C, Co = shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    g = rng.standard_normal((B, H, W, Co)).astype(np.float32)
    got = ops.conv2d_dw_plain(torch.from_numpy(x), torch.from_numpy(g))
    want = np.asarray(conv2d_dw_pallas(jnp.asarray(x), jnp.asarray(g), (3, 3),
                                       tile_h=8, interpret=True))
    assert got.shape == (3, 3, C, Co) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=DW_RTOL * np.abs(want).max())
    # the CPU wrapper is the plain version
    torch.testing.assert_close(
        ops.conv2d_dw(torch.from_numpy(x), torch.from_numpy(g)), got,
        rtol=0, atol=0)


def test_backward_takes_none_for_unused_moments_and_skips_unneeded():
    """Only y reaches the loss (the moments' cotangents are None), and x
    needs no gradient: the backward gives dw, db, ds and dt, and dx None."""
    a = _inputs(1, 9, 11, 64, 64, seed=4)
    x = torch.from_numpy(a["x"])
    w, b, s, t = (torch.from_numpy(a[k]).requires_grad_(True) for k in "wbst")
    y, _, _ = ops.conv2d_fused_prologue_stats(x, w, b, s, t)
    (y * torch.from_numpy(a["cy"])).sum().backward()
    got = {"w": w.grad, "b": b.grad, "s": s.grad, "t": t.grad}
    w2, b2, s2, t2 = (torch.from_numpy(a[k]).requires_grad_(True)
                      for k in "wbst")
    y2 = ops.conv3x3_plain(x, w2, b2, s=s2, t=t2)
    (y2 * torch.from_numpy(a["cy"])).sum().backward()
    for k, want in (("w", w2.grad), ("b", b2.grad), ("s", s2.grad),
                    ("t", t2.grad)):
        torch.testing.assert_close(got[k], want, rtol=0,
                                   atol=GRAD_ATOL * want.abs().max().item())
    dx, dw, db, dres, ds, dt = ops.fused_conv_backward(
        x, w.detach(), y.detach(), torch.from_numpy(a["cy"]),
        s=s.detach(), t=t.detach(),
        needs=(False, True, False, False, False, True))
    assert dx is None and db is None and dres is None and ds is None
    torch.testing.assert_close(dw, got["w"], rtol=0, atol=0)
    torch.testing.assert_close(dt, got["t"], rtol=0, atol=0)
