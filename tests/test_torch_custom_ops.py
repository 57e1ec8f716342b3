"""The kernels' custom ops (``stereoformer::``) on the CPU.

Every kernel entry that a model's forward or backward reaches is a
``torch.library`` custom op: ``corr_band`` and ``corr_band_bf16``,
``local_soft_argmin`` and ``local_soft_argmin_bwd``, ``conv2d_fused`` and
``conv2d_fused_bf16`` (every entry form: residual, prologue, moments, ReLU),
``conv2d_dw`` and ``conv2d_dw_bf16``, ``deform_sample``. Here:

- each has a CUDA, a CPU and a fake (Meta) implementation;
- ``torch.library.opcheck`` passes on each on the CPU, the bf16 forms
  included: the schema, the autograd registration, the fake outputs'
  shapes, dtypes and strides against the CPU implementation's, and the op
  traced with dynamic shapes through its forward and backward;
- each op's CPU value and gradient are bit-equal to what the port computed
  before the ops: autograd of the plain version for ``corr_band``,
  ``local_soft_argmin`` and ``deform_sample``, the closed forms for the
  backward ops and the fused conv's backward (``fused_conv_backward``);
- the CUDA implementations refuse CPU tensors: a tensor that is not on the
  card never reaches a plain version through them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from stereoformer_tpu_torch import kernels, ops  # noqa: E402
from stereoformer_tpu_torch.ops import (  # noqa: E402
    cost_volume,
    deform,
    dw_conv,
    fused_conv,
    local_volume,
)

BF = torch.bfloat16
OPS = ("corr_band", "corr_band_bf16", "local_soft_argmin",
       "local_soft_argmin_bwd", "conv2d_fused", "conv2d_fused_bf16",
       "conv2d_dw", "conv2d_dw_bf16", "deform_sample")


def _t(rng, *shape, dtype=torch.float32, grad=False):
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return t.to(dtype).requires_grad_(grad)


def _candidates(rng, shape, D):
    """Uniform in [-2, D + 1], a third set to the clip bounds and integers."""
    c = rng.uniform(-2, D + 1, shape).astype(np.float32)
    pick = rng.random(shape) < 0.3
    c[pick] = rng.choice(np.array([0.0, D - 1.0, 3.0, -1.0, D], np.float32),
                         size=int(pick.sum()))
    return torch.from_numpy(c)


@pytest.mark.parametrize("name", OPS)
def test_every_kernel_entry_is_a_registered_op(name):
    qualname = f"{kernels.OPS}::{name}"
    for key in ("CUDA", "CPU", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key), \
            (name, key)
    assert hasattr(torch.ops.stereoformer, name)


def _conv_args(rng, dtype, residual, prologue, stats, relu, grad=True):
    B, H, W, C, Co = 2, 5, 7, 8, 16
    x = _t(rng, B, H, W, C, dtype=dtype, grad=grad)
    w = _t(rng, 3, 3, C, Co, dtype=dtype, grad=grad)
    b = _t(rng, Co, dtype=dtype, grad=grad)
    r = _t(rng, B, H, W, Co, dtype=dtype, grad=grad) if residual else None
    s, t = ((_t(rng, B, C, grad=grad), _t(rng, B, C, grad=grad)) if prologue
            else (None, None))
    return x, w, b, r, s, t, relu, stats


# variant -> (residual, prologue, moments, relu): the entry forms RAFT uses
CONV_VARIANTS = {"bare": (False, False, False, False),
                 "res-relu": (True, False, False, True),
                 "prologue": (False, True, False, False),
                 "stats": (False, False, True, False),
                 "prologue-stats": (False, True, True, False)}


def _opcheck_cases():
    rng = np.random.default_rng(0)
    cases = []
    for dtype, op in ((torch.float32, cost_volume.corr_band_op),
                      (BF, cost_volume.corr_band_bf16_op)):
        cases.append(pytest.param(
            op, (_t(rng, 2, 2, 10, 8, dtype=dtype, grad=True),
                 _t(rng, 2, 2, 10, 8, dtype=dtype, grad=True), 4),
            id=f"corr_band-{dtype}"))
    vol, cand = _t(rng, 2, 3, 5, 12, grad=True), _candidates(
        rng, (2, 3, 5, 7), 12).requires_grad_(True)
    cases.append(pytest.param(local_volume.local_soft_argmin_op,
                              (vol, cand), id="local_soft_argmin"))
    cases.append(pytest.param(
        local_volume.local_soft_argmin_bwd_op,
        (vol.detach(), cand.detach(), _t(rng, 2, 3, 5, 1)),
        id="local_soft_argmin_bwd"))
    for dtype in (torch.float32, BF):
        for variant, form in CONV_VARIANTS.items():
            cases.append(pytest.param(
                fused_conv._op(dtype), _conv_args(rng, dtype, *form),
                id=f"conv2d_fused-{variant}-{dtype}"))
        op = dw_conv.conv2d_dw_bf16_op if dtype == BF else dw_conv.conv2d_dw_op
        cases.append(pytest.param(
            op, (_t(rng, 2, 5, 7, 8, dtype=dtype),
                 _t(rng, 2, 5, 7, 16, dtype=dtype)), id=f"conv2d_dw-{dtype}"))
    x, off = _t(rng, 1, 4, 5, 6, grad=True), _t(rng, 1, 4, 5, 9, 2, grad=True)
    mask = torch.rand(1, 4, 5, 9, generator=torch.Generator().manual_seed(0))
    wt = _t(rng, 54, 5, grad=True)
    cases.append(pytest.param(
        deform.deform_sample_op,
        (x, off, mask.requires_grad_(True), wt, 3, 1, 1, 2),
        id="deform_sample"))
    cases.append(pytest.param(deform.deform_sample_op,
                              (x, off, None, wt, 3, 1, 1, 2),
                              id="deform_sample-no-mask"))
    return cases


@pytest.mark.parametrize("op,args", _opcheck_cases())
def test_opcheck_on_the_cpu(op, args):
    torch.library.opcheck(op, args)


# --- the CPU's values and gradients, as before the ops ----------------------

def _grads(out, inputs, cotangent):
    wrt = [a for a in inputs if a is not None and a.requires_grad]
    return torch.autograd.grad(out, wrt, cotangent)


def _leaves(*tensors):
    return [None if t is None else t.detach().clone().requires_grad_(True)
            for t in tensors]


def _assert_equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_corr_band_is_autograd_of_the_plain_version(dtype):
    rng = np.random.default_rng(1)
    left, right = (_t(rng, 2, 3, 20, 16, dtype=dtype) for _ in range(2))
    g = _t(rng, 2, 3, 20, 8, dtype=dtype)
    a = _leaves(left, right)
    b = _leaves(left, right)
    got = ops.correlation_volume(*a, 8)
    want = ops.correlation_volume_plain(*b, 8)
    _assert_equal([got], [want])
    _assert_equal(_grads(got, a, g), _grads(want, b, g))


def test_local_soft_argmin_is_autograd_of_the_plain_version():
    rng = np.random.default_rng(2)
    vol, cand = _t(rng, 2, 4, 6, 24), _candidates(rng, (2, 4, 6, 21), 24)
    g = _t(rng, 2, 4, 6, 1)
    a, b = _leaves(vol, cand), _leaves(vol, cand)
    got = ops.local_soft_argmin(*a)
    want = ops.local_soft_argmin_plain(*b)
    _assert_equal([got], [want])
    _assert_equal(_grads(got, a, g), _grads(want, b, g))
    # the backward op's CPU form is the closed form the kernel follows
    _assert_equal(local_volume.local_soft_argmin_bwd_op(vol, cand, g),
                  ops.local_soft_argmin_backward_plain(vol, cand, g))


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no-mask"])
def test_deform_sample_is_autograd_of_the_windowed_form(with_mask):
    rng = np.random.default_rng(3)
    x, off = _t(rng, 2, 6, 7, 8), 1.5 * _t(rng, 2, 6, 7, 9, 2)
    mask = torch.sigmoid(_t(rng, 2, 6, 7, 9)) if with_mask else None
    wt = _t(rng, 72, 8)
    g = _t(rng, 2, 6, 7, 8)
    a, b = _leaves(x, off, mask, wt), _leaves(x, off, mask, wt)
    got = ops.deform_conv_fused(*a)
    want = ops.modulated_deform_conv_windowed(*b, window=2)
    _assert_equal([got], [want])
    _assert_equal(_grads(got, a, g), _grads(want, b, g))


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("variant", list(CONV_VARIANTS))
def test_fused_conv_keeps_its_value_and_backward(variant, dtype):
    """The value is the plain version's; the gradient is
    ``fused_conv_backward``'s closed form, the CPU's gradient since the
    fused conv's backward was ported (its dx conv and dw through the ops'
    CPU forms, ``conv3x3_plain`` and ``conv2d_dw_plain``)."""
    residual, prologue, stats, relu = CONV_VARIANTS[variant]
    rng = np.random.default_rng(4)
    args = _conv_args(rng, dtype, residual, prologue, stats, relu,
                      grad=False)
    x, w, b, r, s, t = _leaves(*args[:6])
    out = fused_conv.conv3x3_fused(x, w, b, r, relu, s, t, stats)
    want = fused_conv.conv3x3_plain(*args[:3], r, relu, s, t, stats)
    y = out[0] if stats else out
    _assert_equal(out if stats else [out], want if stats else [want])
    gy = _t(rng, *y.shape, dtype=dtype)
    cot = (gy, _t(rng, *out[1].shape), _t(rng, *out[2].shape)) if stats \
        else (gy,)
    got = _grads(out if stats else [out], (x, w, b, r, s, t), cot)
    closed = fused_conv.fused_conv_backward(
        args[0], args[1], y.detach() if relu or stats else None, *cot,
        *([None] * (3 - len(cot))), s=args[4], t=args[5], relu=relu,
        has_residual=residual)
    _assert_equal(got, [c for c in closed if c is not None])


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
def test_conv2d_dw_is_its_plain_version(dtype):
    rng = np.random.default_rng(5)
    x, g = _t(rng, 2, 5, 9, 8, dtype=dtype), _t(rng, 2, 5, 9, 16, dtype=dtype)
    _assert_equal([ops.conv2d_dw(x, g)], [ops.conv2d_dw_plain(x, g)])


# --- no fallback ------------------------------------------------------------

def _cuda_implementations():
    rng = np.random.default_rng(6)
    f, b = _t(rng, 1, 2, 8, 8), _t(rng, 1, 2, 8, 8, dtype=BF)
    vol, cand, g = _t(rng, 1, 2, 8, 12), _t(rng, 1, 2, 8, 5), _t(rng, 1, 2,
                                                                 8, 1)
    x, w, bias = _t(rng, 1, 4, 8, 64), _t(rng, 3, 3, 64, 64), _t(rng, 64)
    off, mask, wt = _t(rng, 1, 2, 8, 9, 2), _t(rng, 1, 2, 8, 9), _t(rng, 72,
                                                                   8)
    return {
        "corr_band": (cost_volume._launch, (f, f, 4)),
        "corr_band_bf16": (cost_volume._launch, (b, b, 4)),
        "local_soft_argmin": (local_volume._launch, (vol, cand)),
        "local_soft_argmin_bwd": (local_volume._launch_bwd, (vol, cand, g)),
        "conv2d_fused": (fused_conv._launch_op,
                         (x, w, bias, None, None, None, True, False)),
        "conv2d_fused_bf16": (fused_conv._launch_op,
                              (x.to(BF), w.to(BF), bias.to(BF), None, None,
                               None, True, False)),
        "conv2d_dw": (dw_conv._launch_op, (x, x)),
        "conv2d_dw_bf16": (dw_conv._launch_op, (x.to(BF), x.to(BF))),
        "deform_sample": (deform._launch, (f, off, mask, wt, 3, 1, 1, 2)),
    }


@pytest.mark.parametrize("name", OPS)
def test_cuda_implementation_refuses_cpu_tensors(name, monkeypatch):
    launched = []
    monkeypatch.setattr(kernels, "launch", lambda *a: launched.append(a))
    fn, args = _cuda_implementations()[name]
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*args)
    assert not launched
