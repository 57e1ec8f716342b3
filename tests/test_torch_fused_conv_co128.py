"""The fused conv at Co = 128, ``FusedConv``'s ``impl`` and ``auto_max_c``
options, and RAFT-Stereo at ``downsample=0``, in the PyTorch port against
the JAX package, on the CPU.

``FusedConv(96, 128)`` (RAFT's layer3 entry at ``downsample=0``) and
``FusedConv(128, 128, auto_max_c=128)`` route to the fused conv, whose CPU
path is the plain version; JAX's ``FusedConv`` of the same variables takes
its XLA route on the CPU and gives no moments, so its moments are float64
sums of its output. The value, the moments and the gradients of x, s, t,
the weight and the bias of a seeded loss over all three are held to
``test_torch_fused_conv.py``'s and ``test_torch_conv_backward.py``'s
tolerances in float32. In bf16 the port's routed conv rounds once where
XLA rounds the conv and its bias apart, so the output is held to the XLA
route within the repo's bf16 bound (``test_torch_bf16.py``), and all of it
to JAX's ``FusedConv(impl="pallas")`` with the Pallas kernel interpreted
within one bf16 ulp (``test_torch_bf16_train_ops.py``'s bound).

The routing: JAX's rule read off JAX's ``FusedConv`` itself, with the
backend taken for a TPU and the Pallas entry points recorded under
``jax.eval_shape``; the port routes where JAX does and the kernel has the
widths, and ``impl="pallas"`` at widths the kernel lacks raises. The CUDA
kernels at Co = 128 are held against their plain versions in
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

import stereoformer_tpu.ops.pallas.conv2d as jpallas  # noqa: E402
from stereoformer_tpu.models.raft_stereo import (  # noqa: E402
    RAFTStereo as JaxRAFTStereo,
)
from stereoformer_tpu.nn.blocks import FusedConv as JaxFusedConv  # noqa: E402
from stereoformer_tpu_torch import ops  # noqa: E402
from stereoformer_tpu_torch.models import RAFTStereo  # noqa: E402
from stereoformer_tpu_torch.nn import FusedConv  # noqa: E402
from stereoformer_tpu_torch.nn.blocks import (  # noqa: E402
    KERNEL_CO,
    kernel_routes,
)
from stereoformer_tpu_torch.weights import (  # noqa: E402
    module_state_dict_from_jax,
    raft_state_dict_from_jax,
)

from test_torch_bf16 import BF16_RTOL, ULP  # noqa: E402
from test_torch_conv_backward import GRAD_ATOL, GRAD_RTOL  # noqa: E402
from test_torch_fused_conv import MOMENT_RTOL, Y_RTOL  # noqa: E402
from test_torch_raft import TOL_PX, _seeded_variables  # noqa: E402

BF = torch.bfloat16
# (C_in, C_out, FusedConv's options): RAFT's 96 -> 128 layer3 entry at
# downsample=0, and a 128 -> 128 site routed by raising auto_max_c
MODULE_CASES = {"96-128": (96, 128, {}),
                "128-128-auto128": (128, 128, {"auto_max_c": 128})}
MODULE_B, MODULE_H, MODULE_W = 2, 9, 21


def _module_inputs(cin, cout, seed):
    rng = np.random.default_rng(seed)
    B, H, W = MODULE_B, MODULE_H, MODULE_W

    def f32(a):
        return np.asarray(a, np.float32)

    return {
        "kernel": f32(rng.standard_normal((3, 3, cin, cout))
                      / np.sqrt(9 * cin)),
        "bias": f32(0.1 * rng.standard_normal(cout)),
        "x": f32(rng.standard_normal((B, H, W, cin))),
        "s": f32(rng.uniform(0.5, 1.5, (B, cin))),
        "t": f32(0.5 * rng.standard_normal((B, cin))),
        # the loss's weights of y, S1 and S2 (S2 sums H W squares: smaller)
        "cy": f32(rng.standard_normal((B, H, W, cout))),
        "c1": f32(0.1 * rng.standard_normal((B, cout))),
        "c2": f32(0.01 * rng.standard_normal((B, cout))),
    }


def _jax_module(cout, opts, dtype, a):
    """JAX's FusedConv of the test's variables: its y, its moments and the
    gradients of the loss with respect to the kernel, the bias, x, s and t
    (numpy). Where its route emits no moments (XLA), the moments are those
    of y."""
    jm = JaxFusedConv(cout, dtype=jnp.bfloat16 if dtype == BF else None,
                      **opts)

    def loss(kernel, bias, x, s, t):
        y, sums = jm.apply({"params": {"kernel": kernel, "bias": bias}}, x,
                           prologue=(s, t), with_stats=True)
        y = y.astype(jnp.float32)
        s1, s2 = sums or (y.sum((1, 2)), (y * y).sum((1, 2)))
        return (jnp.sum(y * a["cy"]) + jnp.sum(s1 * a["c1"])
                + jnp.sum(s2 * a["c2"])), (y, s1, s2)

    names = ("kernel", "bias", "x", "s", "t")
    (_, (y, s1, s2)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(5)), has_aux=True))(
        *(jnp.asarray(a[k]) for k in names))
    y = np.asarray(y, np.float64)
    if opts.get("impl") != "pallas":
        s1, s2 = y.sum((1, 2)), np.square(y).sum((1, 2))
    grads = {k: np.asarray(g, np.float32) for k, g in zip(names, grads)}
    return y, tuple(np.asarray(m, np.float64) for m in (s1, s2)), grads


def _port_module(cin, cout, opts, dtype, a, variables):
    conv = FusedConv(cin, cout, dtype, **opts)
    conv.load_state_dict(module_state_dict_from_jax(conv, variables),
                         strict=True)
    assert conv.routed
    x = (torch.from_numpy(a["x"]).permute(0, 3, 1, 2)
         .contiguous(memory_format=torch.channels_last).requires_grad_(True))
    s, t = (torch.from_numpy(a[k]).requires_grad_(True) for k in "st")
    n = ops.conv2d_fused.launches, ops.conv2d_fused.bf16_launches
    y, (s1, s2) = conv(x, prologue=(s, t), with_stats=True)
    y = y.permute(0, 2, 3, 1)
    assert y.dtype == (dtype or torch.float32)
    loss = ((y.float() * torch.from_numpy(a["cy"])).sum()
            + (s1 * torch.from_numpy(a["c1"])).sum()
            + (s2 * torch.from_numpy(a["c2"])).sum())
    loss.backward()
    # the CPU launches nothing
    assert (ops.conv2d_fused.launches, ops.conv2d_fused.bf16_launches) == n
    grads = {"kernel": conv.weight.grad.permute(2, 3, 1, 0),
             "bias": conv.bias.grad, "x": x.grad.permute(0, 2, 3, 1),
             "s": s.grad, "t": t.grad}
    return (y.detach().double().numpy(),
            tuple(m.detach().double().numpy() for m in (s1, s2)),
            {k: g.float().numpy() for k, g in grads.items()})


def _close_grads(got, want):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (k, err)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=f"d{k}")


def _close_moments(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _within_one_ulp_of_largest(got, want, label):
    """One bf16 ulp of the reference's largest value (its binade), as
    test_torch_bf16_train_ops.py holds the bf16 backward to the Pallas
    VJPs."""
    tol = ULP * 2.0 ** np.floor(np.log2(np.abs(want).max()))
    err = np.abs(got - want).max()
    assert err <= tol, (label, err, tol)


@pytest.mark.parametrize("dtype", [None, BF], ids=["float32", "bf16"])
@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_fused_conv_module_at_co128_matches_jax(case, dtype, monkeypatch):
    """The routed module with the prologue and its moments: the value, the
    moments and the gradients of x, s, t, the weight and the bias. bf16:
    also against JAX's FusedConv(impl="pallas") with the Pallas kernel
    interpreted, which rounds where the port's kernel does (once, the
    moments of the rounded output, the bias gradient a float32 sum), each
    output and gradient within one bf16 ulp of the largest, the moments
    within MOMENT_RTOL of the kernel's; the XLA route rounds the conv and
    its bias apart and sums the bias gradient in bf16."""
    cin, cout, opts = MODULE_CASES[case]
    a = _module_inputs(cin, cout, seed=cin + cout)
    variables = {"params": {"kernel": a["kernel"], "bias": a["bias"]}}
    jy, jm, jgrads = _jax_module(cout, opts, dtype, a)
    y, m, grads = _port_module(cin, cout, opts, dtype, a, variables)
    assert y.shape == jy.shape == (MODULE_B, MODULE_H, MODULE_W, cout)
    if dtype is None:
        np.testing.assert_allclose(y, jy, rtol=0,
                                   atol=Y_RTOL * np.abs(jy).max())
        for got, want in zip(m, jm):
            _close_moments(got, want, MOMENT_RTOL)
        _close_grads(grads, jgrads)
        return
    np.testing.assert_allclose(y, jy, rtol=0,
                               atol=BF16_RTOL * np.abs(jy).max())
    # the entry JAX's FusedConv calls, interpreted with 8-row tiles (its
    # custom VJP calls the module's name again, with those two arguments)
    entry = jpallas.conv2d_fused_prologue_stats
    monkeypatch.setattr(jpallas, "conv2d_fused_prologue_stats",
                        lambda *args: entry(*args[:6], 8, True))
    py, pm, pgrads = _jax_module(cout, dict(opts, impl="pallas"), dtype, a)
    _within_one_ulp_of_largest(y, py, "y")
    # the kernel's moments are of its own rounded output
    for got, want, own in zip(m, pm, (y.sum((1, 2)),
                                      np.square(y).sum((1, 2)))):
        _close_moments(got, own, MOMENT_RTOL)
        _close_moments(got, want, MOMENT_RTOL)
    for k, w in pgrads.items():
        _within_one_ulp_of_largest(grads[k], w, f"d{k}")


# (C_in, C_out): routed or not by each rule, the kernel's widths or not
ROUTING_WIDTHS = [(64, 64), (96, 96), (96, 128), (64, 128), (72, 96),
                  (128, 128), (128, 64), (112, 128), (32, 64), (256, 128),
                  (100, 128), (96, 160), (96, 48)]


def _jax_routes(cin, cout, impl, auto_max_c, calls) -> bool:
    """Whether JAX's FusedConv of these widths calls a Pallas entry point
    (recorded in ``calls``) when the backend is a TPU."""
    jm = JaxFusedConv(cout, impl=impl, auto_max_c=auto_max_c)
    n = len(calls)
    jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x),
                   jax.ShapeDtypeStruct((1, 8, 8, cin), jnp.float32))
    return len(calls) > n


@pytest.mark.parametrize("auto_max_c", [96, 128])
@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_fused_conv_routes_as_jax(impl, auto_max_c, monkeypatch):
    """The port's FusedConv routes where JAX's runs its Pallas kernel and
    the kernels can run and train the widths (C_in and Co 64, 96 or 128);
    with ``impl="auto"`` a site whose widths the kernel lacks is a plain
    conv, with ``impl="pallas"`` it raises when the module is built."""
    calls = []

    def record(x, kernel, *args, **kwargs):
        calls.append((x.shape, kernel.shape))
        return jnp.zeros((*x.shape[:3], kernel.shape[3]), x.dtype)

    monkeypatch.setattr(jpallas, "conv2d_fused", record)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for cin, cout in ROUTING_WIDTHS:
        jax_routes = _jax_routes(cin, cout, impl, auto_max_c, calls)
        widths = cin in KERNEL_CO and cout in KERNEL_CO
        want = jax_routes and widths
        assert kernel_routes(cin, cout, impl, auto_max_c) == want, (cin, cout)
        if impl == "pallas" and not widths:
            assert jax_routes
            with pytest.raises(ValueError, match="impl='pallas'"):
                FusedConv(cin, cout, impl=impl, auto_max_c=auto_max_c)
            continue
        conv = FusedConv(cin, cout, impl=impl, auto_max_c=auto_max_c)
        assert conv.routed == want, (cin, cout)
    assert len(calls) > 0 if impl != "xla" else not calls
    with pytest.raises(ValueError, match="impl must be one of"):
        FusedConv(64, 64, impl="cuda")


@pytest.mark.parametrize("cin,cout", [(72, 128), (80, 128), (88, 128),
                                       (104, 128), (120, 128), (72, 64),
                                       (88, 96)])
def test_fused_conv_routes_only_widths_its_dx_conv_takes(cin, cout):
    """The dx conv of a C_in -> Co conv is the fused conv from Co to C_in
    channels, so a C_in outside the kernel's output widths is not routed
    however auto_max_c is set, and ``impl="pallas"`` refuses it when the
    module is built, where JAX runs its Pallas kernel."""
    assert cin % 8 == 0 and cout in KERNEL_CO and cin not in KERNEL_CO
    for auto_max_c in (96, 128):
        assert not kernel_routes(cin, cout, "auto", auto_max_c)
        assert not FusedConv(cin, cout, auto_max_c=auto_max_c).routed
    with pytest.raises(ValueError, match="dx conv"):
        FusedConv(cin, cout, impl="pallas")


def test_raft_downsample0_eval_matches_jax():
    """RAFT_Stereo(downsample=0): features at full resolution, layer3's
    96 -> 128 entry routed in both encoders (18 routed convs), the eval
    disparities of every iteration within test_torch_raft.py's bound."""
    B, H, W, iters = 1, 32, 64, 2
    rng = np.random.default_rng(3)
    left, right = ((255 * rng.random((B, H, W, 3))).astype(np.float32)
                   for _ in range(2))
    jmodel = JaxRAFTStereo(downsample=0)
    shapes = jax.eval_shape(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, iters=1,
                                 train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)
    model = RAFTStereo(downsample=0).eval()
    model.load_state_dict(raft_state_dict_from_jax(variables), strict=True)
    assert sum(isinstance(m, FusedConv) and m.routed
               for m in model.modules()) == 18
    want = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, a, b: jmodel.apply(v, a, b, iters=iters, train=False))(
        variables, left, right))
    with torch.inference_mode():
        got = model(torch.from_numpy(left), torch.from_numpy(right),
                    iters=iters)
    for key in ("disp_low", "flow_low"):
        assert got[key].shape == want[key].shape == (B, H, W, 1)
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=TOL_PX)
    assert len(got["disparities"]) == len(want["disparities"]) == iters
    for g, w in zip(got["disparities"], want["disparities"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL_PX)
    assert np.abs(want["disp_low"]).max() > 0.1
