"""One train step of each RAFT-Stereo option set in the PyTorch port against
the JAX package's, on the CPU.

The option sets of ``test_torch_raft_options.py`` (the two at wider
shapes, ``downsample=1`` and ``hidden_dims=(96, 96, 96)``, in
``test_torch_raft_options_train_wide.py``); for each, one step of
``train.make_train_step(tx, "sequence", iters=2)`` against JAX's
``make_train_step`` from the same seeded variables (64x128, B=2, AMSGrad lr
1e-3), held to ``test_torch_raft_train.py``'s tolerances: the loss, EPE
and gradient norm, every gradient leaf (JAX's carried into the port's keys
by ``weights.raft_state_dict_from_jax``, so option sets the JAX package's
reference converter does not know are covered), and the context net's
BatchNorm statistics after the step.
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
from test_torch_raft_options import OPTION_SETS  # noqa: E402
from test_torch_raft_train import (  # noqa: E402
    ENCODER_GRAD_RTOL,
    HEAD_GRAD_RTOL,
    NORM_FED_BIAS_ATOL,
    STATS_TOL,
    _check_metrics,
)
from test_torch_train import _record_grads  # noqa: E402

from stereoformer_tpu.models.raft_stereo import (  # noqa: E402
    RAFTStereo as JaxRAFTStereo,
)
from stereoformer_tpu.train import TrainState as JaxTrainState  # noqa: E402
from stereoformer_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from stereoformer_tpu_torch import train  # noqa: E402
from stereoformer_tpu_torch.models import RAFTStereo  # noqa: E402
from stereoformer_tpu_torch.weights import raft_state_dict_from_jax  # noqa: E402

B, H, W, ITERS, LR = 2, 64, 128, 2, 1e-3

# the convs whose output a norm takes, in the port's keys: the stem and
# every residual block's convs and shortcut, not the heads (the context
# net's outputs*.*.1 and outputs32 convs, the feature net's conv2); in
# train mode the context net's BatchNorms take them too
_NORM_FED = re.compile(
    r"(fnet|cnet)\.(conv1|layer\d\.\d\.(conv\d|downsample\.0)"
    r"|outputs(08|16)\.\d\.0\.(conv\d|downsample\.0))\.bias")


# the update block's convs whose output passes a ReLU (the motion encoder's,
# the flow head's first, the mask head's first): at two option sets their
# gradients are limited, as the encoders', by ReLU pre-activations within
# float32 rounding of 0 that pass or block their gradient differently on
# the two sides. Each side's float32 step against a float64 JAX step
# (norm-wise, these leaves' weights; the port, then JAX;
# ``scripts/raft_kink_readings.py``): at
# ``hidden_dims=(96, 96, 96)`` and this file's seed, convf1 2.2e-3 and
# 1.9e-4, but convc1 2.8e-5 and 2.7e-4, convc2 2.4e-5 and 2.5e-4; at a
# second seed (data 2, weights 11) every leaf within 3e-6 on both sides;
# at ``downsample=1`` and this seed mask.0 4.7e-4 and 2.2e-6, convf2
# 1.8e-4 and 4.1e-5, at the second convf1 2.8e-5 and 1.2e-4, mask.0
# 9.9e-4 and 1.1e-4. The side that is further moves with the leaf and the
# seed, as kinks do; at mask.0 the port's 4.7e-4 is the same when
# recomputed in float64 from its own activations and cotangents at that
# conv (its sums are not the cause), and the convs without a ReLU after
# them (the GRUs, mask.2, flow_head.conv2, the context convs) agree to
# 6e-6 [2.2e-3, hidden96 convf1]
KINK_GRAD_RTOL = 5e-3
_KINK = re.compile(r"update_block\.(encoder\.conv\w*|mask\.0|flow_head\.conv1)"
                   r"\.(weight|bias)")
# the sets where they need it; at the others (the default, ``ds3_gru2``,
# ``gru1_corr2r3``: at most 8.6e-5 here) these leaves hold HEAD_GRAD_RTOL,
# as in test_torch_raft_train.py
KINK_SETS = ("ds1", "hidden96")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.mark.parametrize("name", ["default", "ds3_gru2", "gru1_corr2r3"])
def test_option_set_train_step_matches_jax(name):
    check_train_step(name)


def check_train_step(name):
    opts = OPTION_SETS[name]
    rng = np.random.default_rng(0)
    left = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    right = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    gt = (6 + 3 * rng.standard_normal((B, H, W, 1))).astype(np.float32)
    batch = {"img_left": left, "img_right": right, "gt_disp": gt}
    jmodel = JaxRAFTStereo(**opts)
    shapes = jax.eval_shape(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, iters=1,
                                 train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)
    tx = optax.chain(_record_grads(), optax.amsgrad(LR))
    jstep = jax_make_train_step(jmodel, tx, "sequence", iters=ITERS)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    jstate, jm = jax.tree_util.tree_map(np.asarray, jstep(jstate, batch))

    model = RAFTStereo(**opts)
    model.load_state_dict(raft_state_dict_from_jax(variables), strict=True)
    ptx = train.Amsgrad(LR)
    state = train.TrainState.create(model, ptx)
    state, m = train.make_train_step(ptx, "sequence", iters=ITERS)(
        state, {k: _t(v) for k, v in batch.items()})
    _check_metrics({k: float(v) for k, v in m.items()}, jm)

    want = raft_state_dict_from_jax({"params": jstate.opt_state[0]})
    params = dict(model.named_parameters())
    assert sorted(want) == sorted(params)
    for k, p in params.items():
        g, w = p.grad.numpy(), want[k].numpy()
        if _NORM_FED.fullmatch(k):
            scale = NORM_FED_BIAS_ATOL * np.linalg.norm(
                want[k[:-4] + "weight"].numpy())
            assert np.abs(g).max() <= scale and np.abs(w).max() <= scale, k
            continue
        kink = name in KINK_SETS and _KINK.fullmatch(k)
        rtol = (ENCODER_GRAD_RTOL if k.startswith(("fnet.", "cnet."))
                else KINK_GRAD_RTOL if kink else HEAD_GRAD_RTOL)
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= rtol, (k, err)

    stats = raft_state_dict_from_jax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats})
    n_stats = 0
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(),
                                       rtol=STATS_TOL, atol=STATS_TOL,
                                       err_msg=k)
            n_stats += 1
    assert n_stats > 0
