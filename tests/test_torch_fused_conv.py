"""The port's fused stride-1 conv (``ops/fused_conv.py``) against the JAX
package's Pallas kernel, on the CPU.

The JAX entry points run in interpret mode, as ``tests/test_pallas_conv2d.py``
runs them, with ``tile_h=8`` so that H leaves a tail; the port's CPU path is
the plain version. Also: the prologue's zero border, and the ``FusedConv``
module's routing and layout rule. The CUDA kernel itself is held against the
plain version in ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu.ops.pallas.conv2d import (  # noqa: E402
    conv2d_fused as jconv,
    conv2d_fused_prologue as jconv_pro,
    conv2d_fused_prologue_stats as jconv_pro_stats,
    conv2d_fused_stats as jconv_stats,
)
from stereoformer_tpu_torch import ops  # noqa: E402
from stereoformer_tpu_torch.nn import FusedConv  # noqa: E402

# float32 sums of 9*C products in another order than the interpreted
# kernel's: relative to the output's largest magnitude
Y_RTOL = 1e-5
# the moments: sums over H*W outputs (the port's plain version sums in
# float64), relative to each moment's magnitude
MOMENT_RTOL = 1e-4

SHAPES = [(2, 19, 24, 64, 64), (1, 12, 37, 96, 96)]
SHAPE_IDS = ["C64-H-tail", "C96-odd-W"]


def _inputs(B, H, W, C, Co, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((B, H, W, C)).astype(np.float32),
        "w": (rng.standard_normal((3, 3, C, Co)) / np.sqrt(9 * C))
        .astype(np.float32),
        "b": (0.1 * rng.standard_normal(Co)).astype(np.float32),
        "s": rng.uniform(0.5, 1.5, (B, C)).astype(np.float32),
        "t": (0.5 * rng.standard_normal((B, C))).astype(np.float32),
        "r": rng.standard_normal((B, H, W, Co)).astype(np.float32),
    }


def _close_y(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=Y_RTOL * scale)


def _close_moments(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=MOMENT_RTOL,
                               atol=MOMENT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("relu,res", [(True, True), (False, False)],
                         ids=["res-relu", "bare"])
def test_conv2d_fused_matches_pallas(shape, relu, res):
    a = _inputs(*shape)
    r = a["r"] if res else None
    got = ops.conv2d_fused(*(torch.from_numpy(a[k]) for k in "xwb"),
                           None if r is None else torch.from_numpy(r), relu)
    want = jconv(*(jnp.asarray(a[k]) for k in "xwb"),
                 None if r is None else jnp.asarray(r), relu, 8, True)
    _close_y(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_conv2d_fused_prologue_matches_pallas(shape, relu):
    a = _inputs(*shape, seed=1)
    got = ops.conv2d_fused_prologue(
        *(torch.from_numpy(a[k]) for k in "xwbst"), relu)
    want = jconv_pro(*(jnp.asarray(a[k]) for k in "xwbst"), relu, 8, True)
    _close_y(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("prologue", [False, True], ids=["stats", "pro-stats"])
def test_conv2d_fused_moments_match_pallas(shape, prologue):
    """The moments over H*W, the H tail's padded rows left out."""
    a = _inputs(*shape, seed=2)
    keys = "xwbst" if prologue else "xwb"
    fn, jfn = ((ops.conv2d_fused_prologue_stats, jconv_pro_stats) if prologue
               else (ops.conv2d_fused_stats, jconv_stats))
    y, s1, s2 = fn(*(torch.from_numpy(a[k]) for k in keys), False)
    jy, js1, js2 = jfn(*(jnp.asarray(a[k]) for k in keys), False, 8, True)
    _close_y(y.numpy(), jy)
    assert s1.shape == s2.shape == (shape[0], shape[4])
    assert s1.dtype == s2.dtype == torch.float32
    _close_moments(s1.numpy(), js1)
    _close_moments(s2.numpy(), js2)
    # and against float64 sums of the output itself
    y64 = y.double()
    _close_moments(s1.numpy(), y64.sum((1, 2)).numpy())
    _close_moments(s2.numpy(), y64.square().sum((1, 2)).numpy())


def test_prologue_padding_is_zero_not_relu_t():
    """x = 0, s = 1, t = 1, w = 1, b = 0: every in-image tap reads
    relu(0*1 + 1) = 1 and every padding tap 0, so an output counts its
    in-image taps: 9 C inside, 6 C on an edge, 4 C at a corner."""
    B, H, W, C, Co = 1, 5, 7, 8, 32
    x = torch.zeros(B, H, W, C)
    w = torch.ones(3, 3, C, Co)
    y = ops.conv2d_fused_prologue(x, w, torch.zeros(Co), torch.ones(B, C),
                                  torch.ones(B, C))
    taps = torch.full((H, W), 9.0)
    taps[0, :] = taps[-1, :] = taps[:, 0] = taps[:, -1] = 6.0
    taps[0, 0] = taps[0, -1] = taps[-1, 0] = taps[-1, -1] = 4.0
    torch.testing.assert_close(y[0], (C * taps)[..., None].expand(H, W, Co),
                               rtol=0, atol=0)


def _channels_last(x):
    return x.contiguous(memory_format=torch.channels_last)


def test_fused_conv_module_routes_as_the_tpu_did():
    """64 <= C_in <= 96 takes the fused op (its moments come
    back); C_in = 128 takes F.conv2d and gives (y, None). On the CPU both
    take plain versions and launch nothing."""
    torch.manual_seed(0)
    routed, plain = FusedConv(64, 64), FusedConv(128, 64)
    assert routed.routed and not plain.routed
    assert not FusedConv(32, 64).routed and not FusedConv(97, 96).routed
    n = ops.conv2d_fused.launches
    x = _channels_last(torch.randn(2, 64, 9, 11))
    y, sums = routed(x, with_stats=True)
    want = torch.nn.functional.conv2d(x, routed.weight, routed.bias, padding=1)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-5)
    assert y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(sums[0], want.sum((2, 3)), rtol=1e-5,
                               atol=1e-4)
    s, t = torch.rand(2, 128) + 0.5, torch.randn(2, 128)
    x128 = _channels_last(torch.randn(2, 128, 9, 11))
    y, sums = plain(x128, prologue=(s, t), with_stats=True)
    assert sums is None
    want = torch.nn.functional.conv2d(
        torch.relu(x128 * s[:, :, None, None] + t[:, :, None, None]),
        plain.weight, plain.bias, padding=1)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-5)
    assert ops.conv2d_fused.launches == n


def test_fused_conv_module_prologue_at_a_routed_site():
    """The module's NCHW prologue matches relu(x*s + t) fed to the conv;
    routed, with and without moments."""
    torch.manual_seed(1)
    conv = FusedConv(96, 96)
    x = _channels_last(torch.randn(2, 96, 6, 10))
    s, t = torch.rand(2, 96) + 0.5, torch.randn(2, 96)
    want = torch.nn.functional.conv2d(
        torch.relu(x * s[:, :, None, None] + t[:, :, None, None]),
        conv.weight, conv.bias, padding=1)
    torch.testing.assert_close(conv(x, prologue=(s, t)), want, rtol=0,
                               atol=1e-5)
    y, (s1, s2) = conv(x, prologue=(s, t), with_stats=True)
    torch.testing.assert_close(y, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(s2, want.square().sum((2, 3)), rtol=1e-5,
                               atol=1e-4)


def test_routed_site_takes_channels_last_only():
    conv = FusedConv(64, 64)
    with pytest.raises(ValueError, match="channels_last"):
        conv(torch.randn(1, 64, 5, 6))
