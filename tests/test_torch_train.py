"""The PyTorch port's training against the JAX package's, on the CPU.

Losses, metrics, the learning-rate schedule, AMSGrad and BatchNorm against
their JAX counterparts on seeded inputs; then one full train step of
``LowCNN_gru`` (64x256, B=2, two GRU iterations, sequence loss, AMSGrad
lr 1e-3) against JAX's ``make_train_step`` from the same weights: loss,
EPE, gradient norm, every gradient leaf, the updated parameters and the
BatchNorm statistics; and a JAX run carried into the port through
``weights.amsgrad_state_from_jax`` for a second step on both sides.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

torch.set_num_threads(1)

from test_torch_lowcnn import _seeded_variables  # noqa: E402

from stereoformer_tpu import losses as jlosses  # noqa: E402
from stereoformer_tpu import metrics as jmetrics  # noqa: E402
from stereoformer_tpu.models.low_cnn import LowCNN as JaxLowCNN  # noqa: E402
from stereoformer_tpu.train import TrainState as JaxTrainState  # noqa: E402
from stereoformer_tpu.train import make_eval_step as jax_make_eval_step  # noqa: E402
from stereoformer_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from stereoformer_tpu.train.schedule import make_step_schedule as jax_schedule  # noqa: E402
from stereoformer_tpu.train.schedule import reference_lr as jax_reference_lr  # noqa: E402
from stereoformer_tpu.train.torch_import import (  # noqa: E402
    convert_lowcnn_state_dict,
)
from stereoformer_tpu_torch import losses, metrics, train  # noqa: E402
from stereoformer_tpu_torch.models import LowCNN  # noqa: E402
from stereoformer_tpu_torch.nn import BatchNorm2d  # noqa: E402
from stereoformer_tpu_torch.weights import (  # noqa: E402
    amsgrad_state_from_jax,
    lowcnn_state_dict_from_jax,
)

ITERS = 2
LR = 1e-3


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- losses and metrics ----------------------------------------------------

@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(0)
    shape = (2, 16, 32, 1)
    gt = rng.uniform(-10, 200, shape).astype(np.float32)
    gt[0, 0, :4, 0] = [0.0, 192.0, 191.9, 0.1]   # the mask's edges
    preds = [gt + rng.normal(0, s, shape).astype(np.float32)
             for s in (8.0, 3.0, 0.7)]
    low = rng.uniform(0, 24, (2, 2, 4, 1)).astype(np.float32)
    lower = rng.uniform(-1, 3, (2, 2, 4, 1)).astype(np.float32)
    upper = rng.uniform(0, 5, (2, 2, 4, 1)).astype(np.float32)
    return {"gt": gt, "preds": preds, "low": low, "lower": lower,
            "upper": upper, "mask": gt > 5}


def _case(name, inputs, L, M):
    """Call the loss or metric ``name`` of the modules L (losses) and M
    (metrics) on ``inputs`` (already converted to L's array type)."""
    gt, p, mask = inputs["gt"], inputs["preds"], inputs["mask"]
    low, lo, up = inputs["low"], inputs["lower"], inputs["upper"]
    gt8 = p[0][:, ::8, ::8] / 8.0
    return {
        "valid_mask": lambda: L.valid_mask(gt),
        "valid_mask_inclusive": lambda: L.valid_mask(gt, lo_inclusive=True),
        "epe": lambda: L.epe(p[2], gt),
        "smooth_l1_masked": lambda: L.smooth_l1_masked(p[1], gt, mask),
        "sequence_loss": lambda: L.sequence_loss(p, gt, gamma=0.8),
        "single_scale_loss": lambda: L.single_scale_loss(p[2], gt),
        "single_scale_loss_low_res": lambda: L.single_scale_loss(low, gt),
        "multi_scale_loss": lambda: L.multi_scale_loss(p, gt, (0.5, 0.7, 1.0)),
        "multi_equal_loss": lambda: L.multi_equal_loss(p[1:], gt),
        "searching_range_loss": lambda: L.searching_range_loss(
            low, gt8[:, :2, :4], lo, up),
        "total_loss": lambda: L.total_loss(p[2], gt, lo, up, low),
        "total_loss_disp_only": lambda: L.total_loss(p[2], gt,
                                                     disp_only=True),
        "range_and_disparity_loss": lambda: L.range_and_disparity_loss(
            p[1:], gt, low, lo, up),
        "d1_metric": lambda: M.d1_metric(p[0], gt),
        "p1_metric": lambda: M.p1_metric(p[1], gt),
        "thres_metric": lambda: M.thres_metric(p[1], gt, mask, 2.0),
    }[name]()


LOSS_CASES = ["valid_mask", "valid_mask_inclusive", "epe", "smooth_l1_masked",
              "sequence_loss", "single_scale_loss",
              "single_scale_loss_low_res", "multi_scale_loss",
              "multi_equal_loss", "searching_range_loss", "total_loss",
              "total_loss_disp_only", "range_and_disparity_loss",
              "d1_metric", "p1_metric", "thres_metric"]


@pytest.mark.parametrize("name", LOSS_CASES)
def test_losses_and_metrics_match_jax(loss_inputs, name):
    def convert(fn):
        return {k: [fn(x) for x in v] if isinstance(v, list) else fn(v)
                for k, v in loss_inputs.items()}

    got = _case(name, convert(_t), losses, metrics)
    want = _case(name, convert(jnp.asarray), jlosses, jmetrics)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.float32(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        # float32 means over ~1000 pixels of errors up to ~200 px
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --- schedule and optimizer ------------------------------------------------

def test_reference_lr_matches_jax():
    for epoch in range(61):
        np.testing.assert_allclose(train.reference_lr(1e-3, epoch),
                                   float(jax_reference_lr(1e-3, epoch)),
                                   rtol=1e-6)
    assert train.reference_lr(1e-3, 19) == 1e-3
    assert train.reference_lr(1e-3, 20) == 5e-4
    want = jax_schedule(2e-3, 7)
    got = train.make_step_schedule(2e-3, 7)
    for step in (0, 6, 7, 139, 140, 209, 300):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def _amsgrad_run(step_fn, params, steps):
    """Gradients that shrink step by step (x0.3), so the bias-corrected
    second moment falls and the max decides the step size."""
    rng = np.random.default_rng(4)
    g0 = {k: rng.standard_normal(v.shape).astype(np.float32)
          for k, v in params.items()}
    for i in range(steps):
        params = step_fn(params, {k: g * 0.3 ** i for k, g in g0.items()})
    return params


@pytest.mark.parametrize("lr", ["constant", "schedule"])
def test_amsgrad_matches_optax(lr):
    """Four steps of the port's AMSGrad against ``optax.amsgrad``, with a
    constant rate and with a schedule read at the count before the
    increment; ``torch.optim.Adam(amsgrad=True)``, which takes the maximum
    before bias correction, ends elsewhere."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal((3,)).astype(np.float32)}
    rate = 1e-2 if lr == "constant" else (lambda n: 1e-2 / (1 + n))

    tx = optax.amsgrad(rate)
    jstate = tx.init(p0)

    def jax_step(p, g):
        nonlocal jstate
        u, jstate = tx.update(g, jstate, p)
        return jax.tree_util.tree_map(np.asarray, optax.apply_updates(p, u))

    want = _amsgrad_run(jax_step, p0, 4)

    ours = train.Amsgrad(rate)
    params = {k: _t(v.copy()) for k, v in p0.items()}
    state = ours.init(params)

    def port_step(p, g):
        ours.step(state, p, {k: _t(v) for k, v in g.items()})
        return p

    got = _amsgrad_run(port_step, params, 4)
    assert state.count == 4
    for k in p0:
        # float32, four updates of ~1e-2
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-6)

    if lr == "constant":
        ref = {k: _t(v.copy()).requires_grad_(True) for k, v in p0.items()}
        adam = torch.optim.Adam(ref.values(), lr=1e-2, eps=1e-8,
                                amsgrad=True)

        def torch_step(p, g):
            for k, v in p.items():
                v.grad = _t(g[k])
            adam.step()
            return p

        other = _amsgrad_run(torch_step, ref, 4)
        diff = max(np.abs(other[k].detach().numpy() - want[k]).max()
                   for k in p0)
        assert diff > 1e-4, "torch's AMSGrad order should differ from optax's"


# --- BatchNorm -------------------------------------------------------------

def test_batchnorm_matches_flax_over_two_train_calls():
    """Outputs, input and parameter gradients, and the running statistics
    (biased variance, momentum 0.9 in Flax's terms) after two train-mode
    calls, then the eval-mode output."""
    rng = np.random.default_rng(5)
    xs = [(3 + 2 * rng.standard_normal((4, 5, 7, 6))).astype(np.float32)
          for _ in range(2)]
    gs = [rng.standard_normal((4, 5, 7, 6)).astype(np.float32)
          for _ in range(2)]
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = (0.1 * rng.standard_normal(6)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(6)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 6).astype(np.float32)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    ours = BatchNorm2d(6)
    ours.load_state_dict({"weight": _t(scale), "bias": _t(bias),
                          "running_mean": _t(mean0), "running_var": _t(var0),
                          "num_batches_tracked": torch.tensor(0)})
    ours.train()
    for x, g in zip(xs, gs):
        def f(params, xx, stats=variables["batch_stats"]):
            return bn.apply({"params": params, "batch_stats": stats}, xx,
                            mutable=["batch_stats"])

        (want, mutated), vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
        dparams, dx = vjp((jnp.asarray(g), jax.tree_util.tree_map(
            jnp.zeros_like, mutated)))
        variables["batch_stats"] = mutated["batch_stats"]

        xt = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
        ours.weight.grad = ours.bias.grad = None
        got = ours(xt)
        got.backward(_t(g).permute(0, 3, 1, 2))
        # float32 over 140 values per channel
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(want), rtol=0, atol=1e-5)
        np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(dx), rtol=0, atol=1e-5)
        np.testing.assert_allclose(ours.weight.grad.numpy(),
                                   np.asarray(dparams["scale"]), atol=1e-4)
        np.testing.assert_allclose(ours.bias.grad.numpy(),
                                   np.asarray(dparams["bias"]), atol=1e-4)
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    ours.eval()
    with torch.no_grad():
        got = ours(_t(xs[0]).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = fnn.BatchNorm(use_running_average=True).apply(variables, xs[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# --- the train step --------------------------------------------------------

def _record_grads():
    """An optax transformation that passes the updates on and keeps them as
    its state: chained before AMSGrad, the JAX step's gradients come back in
    ``opt_state[0]``."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


@pytest.fixture(scope="module")
def jax_steps():
    """Seeded variables and batch, and two JAX train steps from them, as
    numpy: (variables, batch, [(state, metrics) after step 1, 2])."""
    rng = np.random.default_rng(0)
    left = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    right = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    gt = (40 + 10 * rng.standard_normal((2, 64, 256, 1))).astype(np.float32)
    batch = {"img_left": left, "img_right": right, "gt_disp": gt}
    model = JaxLowCNN(refinement="gru")
    shapes = jax.eval_shape(
        lambda a, b: model.init(jax.random.PRNGKey(0), a, b, iters=1,
                                train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)
    tx = optax.chain(_record_grads(), optax.amsgrad(LR))
    step = jax_make_train_step(model, tx, "sequence", iters=ITERS)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    runs = []
    for _ in range(2):
        state, m = step(state, batch)
        # to numpy before the next step donates the state
        runs.append(jax.tree_util.tree_map(np.asarray, (state, m)))
    return variables, batch, runs


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_tree(model, grads=False):
    """The port's model (or its gradients) as the Flax tree, through the
    JAX package's converter."""
    sd = dict(model.state_dict())
    if grads:
        sd.update({k: p.grad for k, p in model.named_parameters()})
    return convert_lowcnn_state_dict(sd, refinement="gru", strict=True)


def _port_step(variables, batch, opt_state=None, step=0):
    model = LowCNN()
    model.load_state_dict(lowcnn_state_dict_from_jax(variables))
    tx = train.Amsgrad(LR)
    state = train.TrainState.create(model, tx)
    if opt_state is not None:
        state.opt_state = amsgrad_state_from_jax(opt_state, model)
        state.step = step
    train_step = train.make_train_step(tx, "sequence", iters=ITERS)
    state, m = train_step(state, {k: _t(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in m.items()}


# Convs followed by a train-mode BatchNorm: their bias's gradient is 0 in
# exact arithmetic, and float32 noise on both sides (up to ~4e-5 measured)
_BN_FED_BIAS = re.compile(
    r"\['(ResBlock_\d|agg\d)'\]\['(Conv_\d|shortcut_conv)'\]\['bias'\]")
_BACKBONE = re.compile(r"\['(ConvLReLU_0|ResBlock_\d|FPNFusion_0)'\]")
BN_FED_BIAS_ATOL = 1e-4
# Norm-wise relative error per leaf. After the cost volume (aggregation and
# GRU) both sides agree to ~2e-5. Before it, ~20 ReLUs see pre-activations
# within float32 rounding of 0 at some pixels and pass or block their
# gradient differently: against a float64 run of the port, JAX's float32
# gradients there are off by up to 0.2% and the port's by up to 0.7%
# (measured), and the two by up to 0.8%.
REFINE_GRAD_RTOL = 1e-4
BACKBONE_GRAD_RTOL = 3e-2


def _check_grads(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if _BN_FED_BIAS.search(k):
            assert np.abs(g).max() <= BN_FED_BIAS_ATOL, k
            assert np.abs(w).max() <= BN_FED_BIAS_ATOL, k
            continue
        rtol = BACKBONE_GRAD_RTOL if _BACKBONE.match(k) else REFINE_GRAD_RTOL
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= rtol, (k, err)


def _check_updated_params(got, want, before, grads_port, grads_jax):
    """AMSGrad moves a parameter by about lr * g/(|g| + eps), ~lr whatever
    |g|: where the two float32 gradients differ in sign, the updated values
    differ by up to 2 lr. So every parameter is held to 2 lr, and to 1e-6
    where the sign is settled: |g| above 1e-5 (far above eps) and above
    twice the two sides' difference."""
    settled_total = n_total = 0
    for k, w in want.items():
        g = got[k]
        np.testing.assert_array_less(np.abs(g - w), 2 * LR + 1e-6, k)
        gj = grads_jax[k]
        settled = (np.abs(gj) > 1e-5) & (np.abs(gj) > 2 * np.abs(
            grads_port[k] - gj))
        np.testing.assert_allclose(g[settled], w[settled], rtol=0, atol=1e-6,
                                   err_msg=k)
        # and the update did move the parameter
        if settled.any():
            assert not np.array_equal(w[settled], before[k][settled]), k
        settled_total += settled.sum()
        n_total += settled.size
    assert settled_total >= 0.98 * n_total, settled_total / n_total


def test_train_step_matches_jax(jax_steps):
    variables, batch, runs = jax_steps
    (jstate, jm) = runs[0]
    state, m = _port_step(variables, batch)
    assert state.step == 1 and state.opt_state.count == 1
    # float32 losses of ~86 px over 65536 pixels and 2 outputs
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["epe"], jm["epe"], rtol=1e-5)
    # the global norm is dominated by the backbone's leaves (see above)
    np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=3e-4)

    grads_port = _flat(_port_tree(state.model, grads=True)["params"])
    grads_jax = _flat(jstate.opt_state[0])
    _check_grads(grads_port, grads_jax)

    tree = _port_tree(state.model)
    _check_updated_params(_flat(tree["params"]), _flat(jstate.params),
                          _flat(variables["params"]), grads_port, grads_jax)
    got_stats, want_stats = _flat(tree["batch_stats"]), _flat(
        jstate.batch_stats)
    assert sorted(got_stats) == sorted(want_stats)
    for k, w in want_stats.items():
        # float32 batch moments; variances up to ~700
        np.testing.assert_allclose(got_stats[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_dp_step_in_two_ranks_matches_jax(jax_steps, tmp_path):
    """The same step data parallel: two gloo ranks (tests/_torch_parallel_
    worker.py), one row each, global BatchNorm statistics and losses, the
    gradients summed; against JAX's step on both rows with the checks
    above."""
    import _torch_parallel_worker as worker

    variables, batch, runs = jax_steps
    (jstate, jm) = runs[0]
    torch.save({"state_dict": lowcnn_state_dict_from_jax(variables),
                "batch": batch}, tmp_path / "jax_rows.pt")
    out = worker.run_ranks(["jax_rows"], str(tmp_path))
    for r in (0, 1):
        got = out[("jax_rows", r)]
        assert got["step"] == got["count"] == 1
        m = got["metrics"]
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["epe"], jm["epe"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=3e-4)
    model = LowCNN()
    model.load_state_dict(out[("jax_rows", 0)]["state_dict"])
    for k, p in model.named_parameters():
        p.grad = out[("jax_rows", 0)]["grads"][k]
    grads_port = _flat(_port_tree(model, grads=True)["params"])
    grads_jax = _flat(jstate.opt_state[0])
    _check_grads(grads_port, grads_jax)
    tree = _port_tree(model)
    _check_updated_params(_flat(tree["params"]), _flat(jstate.params),
                          _flat(variables["params"]), grads_port, grads_jax)
    got_stats, want_stats = _flat(tree["batch_stats"]), _flat(
        jstate.batch_stats)
    assert sorted(got_stats) == sorted(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_amsgrad_state_from_jax_continues_a_jax_run(jax_steps):
    """JAX's state after one step (parameters, BatchNorm statistics, the
    AMSGrad moments and count) carried into the port; the second step on
    both sides."""
    variables, batch, runs = jax_steps
    (jstate1, _), (jstate2, jm2) = runs
    carried = {"params": jstate1.params, "batch_stats": jstate1.batch_stats}
    state, m = _port_step(carried, batch, opt_state=jstate1.opt_state, step=1)
    assert state.step == 2 and state.opt_state.count == 2
    np.testing.assert_allclose(m["loss"], jm2["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["epe"], jm2["epe"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], jm2["grad_norm"], rtol=3e-4)
    grads_port = _flat(_port_tree(state.model, grads=True)["params"])
    grads_jax = _flat(jstate2.opt_state[0])
    _check_grads(grads_port, grads_jax)
    # the first moment after step 2, 0.9 mu_1 + 0.1 g_2, mapped back to the
    # Flax tree: the carried moment plus this step's gradient
    got_mu = _flat(convert_lowcnn_state_dict(
        {**state.model.state_dict(), **state.opt_state.mu})["params"])
    _check_grads(got_mu, _flat(jstate2.opt_state[1][0].mu))


def test_freeze_bn_keeps_statistics_and_trains_parameters(jax_steps):
    variables, batch, _ = jax_steps
    model = LowCNN()
    model.load_state_dict(lowcnn_state_dict_from_jax(variables))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = train.Amsgrad(LR)
    state = train.TrainState.create(model, tx)
    step = train.make_train_step(tx, iters=1, freeze_bn=True)
    small = {k: _t(v[:1, :32, :128]) for k, v in batch.items()}
    state, m = step(state, small)
    after = model.state_dict()
    for k, v in before.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert torch.equal(after[k], v), k
    assert all(p.grad is not None for p in model.parameters())
    assert not torch.equal(after["conv1.0.weight"], before["conv1.0.weight"])
    assert np.isfinite(float(m["loss"]))


def test_train_step_rejects_unported_and_unknown_losses():
    # every loss of the JAX step is ported ("range_supervised" with the
    # learned_supervised model, tests/test_torch_lowcnn_dynamic.py)
    assert train.LOSS_NAMES == ("sequence", "equal", "single",
                                "range_supervised")
    for name in train.LOSS_NAMES:
        assert callable(train.make_train_step(train.Amsgrad(LR), name))
    with pytest.raises(ValueError, match="unknown loss"):
        train.make_train_step(train.Amsgrad(LR), "l2")


def test_eval_step_matches_jax(jax_steps):
    """Eval at 64x256 against ground truth at 32x128: the prediction is
    resized and rescaled by scale_disp before EPE and P1."""
    variables, batch, _ = jax_steps
    gt = batch["gt_disp"][:, ::2, ::2] / 2
    jbatch = {"img_left": batch["img_left"], "img_right": batch["img_right"],
              "gt_disp": gt}
    jstate = JaxTrainState(step=0, params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=None)
    want = jax_make_eval_step(JaxLowCNN(refinement="gru"),
                              iters=ITERS)(jstate, jbatch)
    model = LowCNN()
    model.load_state_dict(lowcnn_state_dict_from_jax(variables))
    state = train.TrainState.create(model, train.Amsgrad(LR))
    got = train.make_eval_step(iters=ITERS)(
        state, {k: _t(v) for k, v in jbatch.items()})
    assert got["pred"].shape == (2, 32, 128, 1)
    # eval outputs agree to 1e-3 px (tests/test_torch_lowcnn.py)
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(got["epe"]), float(want["epe"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(got["p1"]), float(want["p1"]),
                               rtol=0, atol=1e-3)
    infer = train.make_infer_fn(iters=ITERS)
    out = infer(state, _t(batch["img_left"]), _t(batch["img_right"]))
    assert out.shape == (2, 64, 256, 1)
