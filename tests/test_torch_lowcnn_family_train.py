"""One train step of the rest of the LowCNN family in the port against JAX's
``make_train_step``, on the CPU: ``LowCNN`` (loss "single"), ``LowCNN_ada``
("equal") and ``LowCNN_gru2`` ("sequence"), each with its trainer's default
loss (``stereoformer_tpu/train/trainer.py::_DEFAULT_LOSS``); and
``LowCNN_gru`` with ``upsample="simple"``, whose GRU mask head lies outside
the loss: its gradient is zero and it stays as it was, as in JAX.

At the small shapes of ``tests/test_torch_lowcnn.py`` (64x256, B=2) from
seeded JAX variables bridged through ``weights.lowcnn_state_dict_from_jax``:
loss, EPE, gradient norm, every gradient leaf, BatchNorm statistics and the
updated parameters, with the tolerances of ``tests/test_torch_train.py``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

torch.set_num_threads(1)

from test_torch_lowcnn import _seeded_variables  # noqa: E402
from test_torch_train import (  # noqa: E402
    _check_updated_params,
    _record_grads,
)

from stereoformer_tpu.models.low_cnn import LowCNN as JaxLowCNN  # noqa: E402
from stereoformer_tpu.train import TrainState as JaxTrainState  # noqa: E402
from stereoformer_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from stereoformer_tpu_torch import train  # noqa: E402
from stereoformer_tpu_torch.models import LowCNN  # noqa: E402
from stereoformer_tpu_torch.weights import lowcnn_state_dict_from_jax  # noqa: E402

LR = 1e-3
ITERS = 2
# case -> (the LowCNN options, the loss)
CASES = {
    "LowCNN": ({"refinement": "fixed"}, "single"),
    "LowCNN_ada": ({"refinement": "variance"}, "equal"),
    "LowCNN_gru2": ({"refinement": "gru_feature"}, "sequence"),
    "LowCNN_gru-simple-upsample": ({"refinement": "gru",
                                    "upsample": "simple"}, "sequence"),
}
# the GRU mask head, which upsample="simple" leaves unread
MASK_HEAD = "local_cost_volume.mask."
# The ResBlocks' convs, each followed by a train-mode BatchNorm: their
# bias's gradient is 0 in exact arithmetic and float32 noise on both sides,
# which grows with the gradient through the conv (1.8e-4 measured in
# LowCNN_ada's aggregation, whose weight gradient reaches 7): held to 1e-4 of
# the largest weight gradient of the same conv
_BN_FED_BIAS = re.compile(
    r"^(conv[23]|downsample\d|correlation_aggreagtion\.\d)\."
    r"(conv[12]|shortcut\.0)\.bias$")
BN_FED_BIAS_RTOL = 1e-4
# Norm-wise relative error per leaf. In the backbone ~20 ReLUs see
# pre-activations within float32 rounding of 0 and pass or block their
# gradient differently (up to ~1% measured, tests/test_torch_train.py).
# Past the backbone, against a float64 run of the port: in LowCNN and
# LowCNN_ada each side lies within 5e-5 and the two within 8.6e-5 of each
# other (the variance refiner's root variance included); in LowCNN_gru2 the
# leaves that feed a ReLU (the mask head's first conv, the guidance and
# feature encoders' convs) take the same kinks, 128 GRU channels wide: on
# mask.0 the port lies 3.2e-4 and JAX 6.8e-4 from float64, the two 7.5e-4
# apart (measured)
_BACKBONE = ("conv1.", "conv2.", "conv3.", "downsample", "feature_concated.")
BACKBONE_GRAD_RTOL = 3e-2
REFINE_GRAD_RTOL = {"LowCNN": 2e-4, "LowCNN_ada": 2e-4, "LowCNN_gru2": 2e-3,
                    "LowCNN_gru-simple-upsample": 2e-4}
# the global norm is dominated by the backbone's leaves
GRAD_NORM_RTOL = 3e-4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    left = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    right = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    gt = (40 + 10 * rng.standard_normal((2, 64, 256, 1))).astype(np.float32)
    return {"img_left": left, "img_right": right, "gt_disp": gt}


@pytest.fixture(scope="module")
def jax_steps(batch):
    """case -> (seeded variables, (state, metrics) after one JAX step), as
    numpy."""
    runs = {}
    for case, (kw, loss) in CASES.items():
        model = JaxLowCNN(**kw)
        shapes = jax.eval_shape(
            lambda a, b, m=model: m.init(jax.random.PRNGKey(0), a, b, iters=1,
                                         train=False),
            batch["img_left"], batch["img_right"])
        variables = _seeded_variables(shapes, seed=1)
        tx = optax.chain(_record_grads(), optax.amsgrad(LR))
        step = jax_make_train_step(model, tx, loss, iters=ITERS)
        state = JaxTrainState(step=jnp.asarray(0, jnp.int32),
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
        runs[case] = (variables, jax.tree_util.tree_map(
            np.asarray, step(state, batch)))
    return runs


def _port_step(case, variables, batch):
    kw, loss = CASES[case]
    model = LowCNN(**kw)
    model.load_state_dict(lowcnn_state_dict_from_jax(variables), strict=True)
    tx = train.Amsgrad(LR)
    state = train.TrainState.create(model, tx)
    state, m = train.make_train_step(tx, loss, iters=ITERS)(
        state, {k: _t(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in m.items()}


def _check_grads(got, want, refine_rtol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if _BN_FED_BIAS.search(k):
            atol = BN_FED_BIAS_RTOL * np.abs(want[k[:-4] + "weight"]).max()
            assert np.abs(g).max() <= atol, k
            assert np.abs(w).max() <= atol, k
            continue
        if not w.any():
            # a leaf outside the loss: exactly zero on both sides
            assert not g.any(), k
            continue
        rtol = BACKBONE_GRAD_RTOL if k.startswith(_BACKBONE) else refine_rtol
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= rtol, (k, err)


def _step_and_compare(jax_steps, batch, case, skip=()):
    """The port's step against JAX's; returns (port state, the port's
    gradients, JAX's gradients, the parameters before), numpy, under the
    port's keys. ``skip``: key prefixes left out of the updated-parameter
    check (which asks every settled leaf to move)."""
    variables, (jstate, jm) = jax_steps[case]
    state, m = _port_step(case, variables, batch)
    assert state.step == 1 and state.opt_state.count == 1
    # float32 losses of ~40 px over 32768 pixels
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["epe"], jm["epe"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                               rtol=GRAD_NORM_RTOL)
    grads_port = {k: p.grad.numpy()
                  for k, p in state.model.named_parameters()}
    grads_jax = {k: v.numpy() for k, v in lowcnn_state_dict_from_jax(
        {"params": jstate.opt_state[0]}).items()}
    _check_grads(grads_port, grads_jax, REFINE_GRAD_RTOL[case])

    want = {k: v.numpy() for k, v in lowcnn_state_dict_from_jax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}).items()}
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    before = {k: v.numpy() for k, v in lowcnn_state_dict_from_jax(
        variables).items()}
    keys = [k for k in grads_port if not k.startswith(skip)]
    _check_updated_params({k: got[k] for k in keys},
                          {k: want[k] for k in keys}, before, grads_port,
                          grads_jax)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        # float32 batch moments
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    return got, want, before, grads_port, grads_jax


@pytest.mark.parametrize("case", ["LowCNN", "LowCNN_ada", "LowCNN_gru2"])
def test_train_step_matches_jax(jax_steps, batch, case):
    _, _, _, grads_port, _ = _step_and_compare(jax_steps, batch, case)
    if case == "LowCNN_gru2":
        # the v2 step's feature encoder is trained
        assert np.abs(grads_port[
            "local_cost_volume.feature_encode.weight"]).max() > 0


def test_unread_mask_head_gets_a_zero_gradient_and_stays(jax_steps, batch):
    """LowCNN_gru with upsample="simple": nothing reads the GRU step's mask
    head, so JAX's gradient there is zero and optax leaves it as it was; the
    port's step gives it the same zero gradient (autograd leaves it None,
    which the norm and AMSGrad could not take) and leaves it as it was."""
    got, want, before, grads_port, grads_jax = _step_and_compare(
        jax_steps, batch, "LowCNN_gru-simple-upsample", skip=(MASK_HEAD,))
    head = [k for k in grads_port if k.startswith(MASK_HEAD)]
    assert len(head) == 4
    for k in head:
        assert not grads_jax[k].any() and not grads_port[k].any(), k
        np.testing.assert_array_equal(want[k], before[k], err_msg=k)
        np.testing.assert_array_equal(got[k], before[k], err_msg=k)
