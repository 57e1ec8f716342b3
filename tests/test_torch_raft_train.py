"""The PyTorch port's RAFT-Stereo train step against the JAX package's, on
the CPU.

One step of ``train.make_train_step(tx, "sequence", iters=2)`` on
``RAFTStereo`` (64x128, B=2, sequence loss with gamma 0.8, AMSGrad lr 1e-3)
against JAX's ``make_train_step`` from the same seeded variables
(``test_torch_raft._seeded_variables``, bridged by
``weights.raft_state_dict_from_jax``): the train-mode outputs of every
iteration, loss, EPE and gradient norm, every gradient leaf (mapped back to
the Flax tree by ``convert_raft_state_dict``), the context net's updated
BatchNorm statistics and the updated parameters. Then a JAX step carried
into the port through ``weights.amsgrad_state_from_jax`` and one more step
on both sides, and a ``freeze_bn=True`` step.

On the CPU the JAX model runs its fused convs as XLA convs; the port runs
its fused op, whose backward is the hand-written ``fused_conv_backward``
with the plain versions of the dx conv and the dw kernel inside.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

torch.set_num_threads(1)

from test_torch_raft import _seeded_variables  # noqa: E402
from test_torch_train import _flat, _record_grads  # noqa: E402

from stereoformer_tpu.models.raft_stereo import (  # noqa: E402
    RAFTStereo as JaxRAFTStereo,
)
from stereoformer_tpu.train import TrainState as JaxTrainState  # noqa: E402
from stereoformer_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from stereoformer_tpu.train.torch_import import (  # noqa: E402
    convert_raft_state_dict,
)
from stereoformer_tpu_torch import ops, train  # noqa: E402
from stereoformer_tpu_torch.models import RAFTStereo  # noqa: E402
from stereoformer_tpu_torch.weights import (  # noqa: E402
    amsgrad_state_from_jax,
    raft_state_dict_from_jax,
)

B, H, W, ITERS, LR = 2, 64, 128, 2, 1e-3

# Tolerances, each with what was measured on these inputs in brackets:
# train-mode disparities of both iterations, px (up to ~10 px) [4.1e-5]
OUT_TOL_PX = 1e-4
# the loss and EPE, relative: float32 means over 16384 pixels [2.7e-7]
LOSS_RTOL = 1e-5
# the global gradient norm, relative [9.2e-6]
GNORM_RTOL = 1e-4
# Gradient leaves, norm-wise relative. The update block, the context convs
# and the heads agree to [9.8e-5]; the encoders' leaves less well, as in the
# LowCNN train step (tests/test_torch_train.py, same tolerance): ReLUs whose
# pre-activations lie within float32 rounding of 0 pass or block their
# gradient differently on the two sides [1.1e-2, a BatchNorm shift].
HEAD_GRAD_RTOL = 3e-4
ENCODER_GRAD_RTOL = 3e-2
# convs whose output a norm takes: their bias's gradient is 0 in exact
# arithmetic, float32 noise on both sides, relative to the norm of the
# conv's weight gradient [2.3e-7]
NORM_FED_BIAS_ATOL = 1e-5
# running means and variances of the context net's BatchNorms (up to 1.5),
# after one momentum-0.9 update from float32 batch moments [2.3e-6]
STATS_TOL = 1e-5
# updated parameters where the gradient's sign is settled [9.8e-7], and the
# share of parameters that are settled [94.9%]
PARAM_TOL, SETTLED_SHARE = 2e-6, 0.9

_ENCODER = re.compile(r"\['(fnet|cnet)'\]")


def _norm_fed_bias(net):
    """The biases of ``net``'s convs whose output a norm takes: the stem and
    every residual block's convs and downsample, not the heads (the context
    net's out*_conv, the feature net's Conv_1)."""
    return re.compile(
        rf"\['{net}'\]\[('(layer\d[ab]|down\d[ab]|out\d_\d_res)'\]"
        rf"\['(Conv_\d|downsample)'|'Conv_0')\]\['bias'\]")


# instance norms in the feature net always; the context net's BatchNorms only
# in train mode (with frozen statistics they are affine maps)
_NORM_FED = {False: (_norm_fed_bias("fnet"), _norm_fed_bias("cnet")),
             True: (_norm_fed_bias("fnet"),)}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.fixture(scope="module")
def raft_train():
    """Seeded variables and batch (raw 0..255 images), JAX's train-mode
    outputs, and two JAX train steps from them, as numpy: (variables, batch,
    outputs, [(state, metrics) after step 1, 2])."""
    rng = np.random.default_rng(0)
    left = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    right = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    gt = (6 + 3 * rng.standard_normal((B, H, W, 1))).astype(np.float32)
    batch = {"img_left": left, "img_right": right, "gt_disp": gt}
    jmodel = JaxRAFTStereo()
    shapes = jax.eval_shape(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, iters=1,
                                 train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)
    out, _ = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, iters=ITERS, train=True, mutable=["batch_stats"]))(
        variables, left, right)
    outputs = [np.asarray(d) for d in out["disparities"]]
    tx = optax.chain(_record_grads(), optax.amsgrad(LR))
    step = jax_make_train_step(jmodel, tx, "sequence", iters=ITERS)
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    runs = []
    for _ in range(2):
        state, m = step(state, batch)
        # to numpy before the next step donates the state
        runs.append(jax.tree_util.tree_map(np.asarray, (state, m)))
    return variables, batch, outputs, runs


def _port_model(variables):
    model = RAFTStereo()
    model.load_state_dict(raft_state_dict_from_jax(variables))
    return model


def _port_step(model, batch, opt_state=None, step=0, freeze_bn=False):
    tx = train.Amsgrad(LR)
    state = train.TrainState.create(model, tx)
    if opt_state is not None:
        state.opt_state = amsgrad_state_from_jax(opt_state, model)
        state.step = step
    train_step = train.make_train_step(tx, "sequence", iters=ITERS,
                                       freeze_bn=freeze_bn)
    state, m = train_step(state, {k: _t(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in m.items()}


def _port_tree(model, grads=False):
    """The port's model (or its gradients) as the Flax tree, through the
    JAX package's converter."""
    sd = dict(model.state_dict())
    if grads:
        sd.update({k: p.grad for k, p in model.named_parameters()})
    return convert_raft_state_dict(sd, strict=True)


def _check_metrics(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["epe"], want["epe"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GNORM_RTOL)


def _check_grads(got, want, freeze_bn=False):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if any(r.search(k) for r in _NORM_FED[freeze_bn]):
            wk = want[k.replace("['bias']", "['kernel']")]
            scale = NORM_FED_BIAS_ATOL * np.linalg.norm(wk)
            assert np.abs(g).max() <= scale and np.abs(w).max() <= scale, k
            continue
        rtol = ENCODER_GRAD_RTOL if _ENCODER.match(k) else HEAD_GRAD_RTOL
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= rtol, (k, err)


def _check_updated_params(got, want, before, grads_port, grads_jax):
    """AMSGrad moves a parameter by about lr * g/(|g| + eps), ~lr whatever
    |g|: where the two float32 gradients differ in sign the updated values
    differ by up to 2 lr. Every parameter is held to 2 lr, and to
    ``PARAM_TOL`` where the sign is settled: |g| above 1e-5 and above twice
    the two sides' difference."""
    settled_total = n_total = 0
    for k, w in want.items():
        g = got[k]
        np.testing.assert_array_less(np.abs(g - w), 2 * LR + 1e-6, k)
        gj = grads_jax[k]
        settled = (np.abs(gj) > 1e-5) & (np.abs(gj) > 2 * np.abs(
            grads_port[k] - gj))
        np.testing.assert_allclose(g[settled], w[settled], rtol=0,
                                   atol=PARAM_TOL, err_msg=k)
        if settled.any():
            assert not np.array_equal(w[settled], before[k][settled]), k
        settled_total += settled.sum()
        n_total += settled.size
    assert settled_total >= SETTLED_SHARE * n_total, settled_total / n_total


def test_raft_train_step_matches_jax(raft_train):
    variables, batch, outputs, runs = raft_train
    jstate, jm = runs[0]
    model = _port_model(variables).train()
    with torch.no_grad():
        out = model(_t(batch["img_left"]), _t(batch["img_right"]),
                    iters=ITERS)
    assert len(out["disparities"]) == ITERS
    for got, want in zip(out["disparities"], outputs):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_TOL_PX)

    model = _port_model(variables)
    n = ops.conv2d_fused.launches, ops.conv2d_dw.launches
    state, m = _port_step(model, batch)
    # the CPU takes the plain versions and launches nothing
    assert (ops.conv2d_fused.launches, ops.conv2d_dw.launches) == n
    assert state.step == 1 and state.opt_state.count == 1
    _check_metrics(m, jm)
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
        np.testing.assert_allclose(got_stats[k], w, rtol=STATS_TOL,
                                   atol=STATS_TOL, err_msg=k)


def test_amsgrad_state_from_jax_continues_a_jax_raft_run(raft_train):
    """JAX's state after one step (parameters, BatchNorm statistics, the
    AMSGrad moments and count) carried into the port; the second step on
    both sides."""
    _, batch, _, ((jstate1, _), (jstate2, jm2)) = raft_train
    model = _port_model({"params": jstate1.params,
                         "batch_stats": jstate1.batch_stats})
    state, m = _port_step(model, batch, opt_state=jstate1.opt_state, step=1)
    assert state.step == 2 and state.opt_state.count == 2
    _check_metrics(m, jm2)
    _check_grads(_flat(_port_tree(model, grads=True)["params"]),
                 _flat(jstate2.opt_state[0]))
    # the first moment after step 2, 0.9 mu_1 + 0.1 g_2, mapped back to the
    # Flax tree
    got_mu = _flat(convert_raft_state_dict(
        {**model.state_dict(), **state.opt_state.mu})["params"])
    _check_grads(got_mu, _flat(jstate2.opt_state[1][0].mu))


def test_freeze_bn_step_matches_jax(raft_train):
    """``freeze_bn=True``: the context net's BatchNorms take their running
    statistics as the conv prologue (the eval seam) and keep them, while
    their scale and shift still get gradients through s and t."""
    variables, batch, _, _ = raft_train
    tx = optax.chain(_record_grads(), optax.amsgrad(LR))
    step = jax_make_train_step(JaxRAFTStereo(), tx, "sequence", iters=ITERS,
                               freeze_bn=True)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    jstate, jm = jax.tree_util.tree_map(np.asarray, step(jstate, batch))
    model = _port_model(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, m = _port_step(model, batch, freeze_bn=True)
    assert not model.training
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, before[k]), k
    _check_metrics(m, jm)
    grads_port = _flat(_port_tree(model, grads=True)["params"])
    grads_jax = _flat(jstate.opt_state[0])
    _check_grads(grads_port, grads_jax, freeze_bn=True)
    bn_scale = "['cnet']['layer1a']['_Norm_0']['BatchNorm_0']['scale']"
    assert np.linalg.norm(grads_port[bn_scale]) > 0


def test_train_mode_batch_norm_is_not_fused():
    """A train-mode BatchNorm has no affine form (the JAX ``_Norm`` returns
    None): ``norm_affine`` refuses it, and the context net's residual block
    feeds its second conv relu(norm1(y)) with the batch's statistics."""
    from stereoformer_tpu_torch.nn.raft.encoders import (
        RaftResidualBlock,
        norm_affine,
    )

    torch.manual_seed(0)
    block = RaftResidualBlock(64, 64, "batch").train()
    x = torch.randn(2, 64, 6, 10).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="train mode"):
        norm_affine(block.norm1, x)
    with torch.no_grad():
        got = block(x)
        y = block.conv1(x)
        want = torch.relu(x + torch.relu(block.norm2(block.conv2(
            torch.relu(block.norm1(y))))))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
