"""The port's stride-2 fused conv against the JAX package's, on the CPU.

``ops.conv2d_fused_s2`` (on CPU tensors its plain version, the kernel
``csrc/conv2d_s2.cu`` being held against that plain version on the card in
``tests/test_torch_kernels.py``) against the Pallas ``conv2d_fused_s2`` run
in interpret mode and against its XLA reference ``_reference_s2``, with and
without ReLU: values within 2e-5 and gradients within 2e-4, the JAX test's
tolerances (``tests/test_pallas_conv2d.py::test_conv2d_fused_s2``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu.ops.pallas.conv2d import (  # noqa: E402
    _reference_s2,
    conv2d_fused_s2 as jax_conv2d_fused_s2,
)
from stereoformer_tpu_torch import ops  # noqa: E402

# (B, H, W, C, Co): the JAX test's shape (two row tiles of 8, the second
# padded), a row count that no tile divides with C and Co no multiple of 4,
# and one with more channels than a kernel block takes (Co > 32)
SHAPES = [(2, 20, 48, 16, 24), (1, 34, 22, 6, 10), (2, 12, 70, 40, 48)]
VALUE_ATOL = 2e-5
GRAD_ATOL = 2e-4


def _inputs(shape):
    B, H, W, C, Co = shape
    rng = np.random.RandomState(7)
    return (rng.randn(B, H, W, C).astype(np.float32),
            (0.1 * rng.randn(3, 3, C, Co)).astype(np.float32),
            (0.1 * rng.randn(Co)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("relu", [False, True], ids=["bare", "relu"])
@pytest.mark.parametrize("shape", SHAPES, ids=["jax-test", "odd-C-Co",
                                               "wide-Co"])
def test_conv2d_fused_s2_matches_pallas_and_reference(shape, relu):
    x, w, b = _inputs(shape)
    pallas = np.asarray(jax_conv2d_fused_s2(x, w, b, relu, 8, True))
    reference = np.asarray(_reference_s2(x, w, b, relu))
    got = ops.conv2d_fused_s2(_t(x), _t(w), _t(b), relu).numpy()
    B, H, W, _, Co = shape
    assert got.shape == pallas.shape == (B, H // 2, W // 2, Co)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=VALUE_ATOL)
    np.testing.assert_allclose(got, reference, rtol=0, atol=VALUE_ATOL)

    def f(fn):
        return lambda x, w, b: jnp.sum(jnp.sin(fn(x, w, b)))

    want = jax.grad(f(lambda *a: jax_conv2d_fused_s2(*a, relu, 8, True)),
                    argnums=(0, 1, 2))(x, w, b)
    args = [_t(a).requires_grad_(True) for a in (x, w, b)]
    torch.sin(ops.conv2d_fused_s2(*args, relu)).sum().backward()
    for a, g in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=GRAD_ATOL)


def test_conv2d_fused_s2_backward_takes_only_the_gradients_asked_for():
    x, w, b = (_t(a) for a in _inputs(SHAPES[0]))
    got = w.clone().requires_grad_(True)
    ops.conv2d_fused_s2(x, got, b, True).square().sum().backward()
    want = w.clone().requires_grad_(True)
    ops.conv3x3_s2_plain(x, want, b, True).square().sum().backward()
    torch.testing.assert_close(got.grad, want.grad)


def test_conv2d_fused_s2_refuses_odd_sizes():
    x, w, b = (_t(a) for a in _inputs(SHAPES[0]))
    with pytest.raises(ValueError, match="H and W even"):
        ops.conv2d_fused_s2(x[:, :19], w, b)
    with pytest.raises(ValueError, match="H and W even"):
        ops.conv2d_fused_s2(x[:, :, :47], w, b)
    # the JAX kernel asserts the same
    with pytest.raises(AssertionError):
        jax_conv2d_fused_s2(np.asarray(x[:, :19]), np.asarray(w),
                            np.asarray(b), False, 8, True)
