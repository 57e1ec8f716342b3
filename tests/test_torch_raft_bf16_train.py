"""The port's RAFT-Stereo bf16 train step against the JAX package's, on the
CPU.

One step of ``train.make_train_step(tx, "sequence", iters=2)`` on
``RAFTStereo(dtype=torch.bfloat16)`` (64x128, B=2, raw 0..255 images,
AMSGrad lr 1e-3) against JAX's ``make_train_step`` on
``RAFTStereo(dtype=jnp.bfloat16)`` from the same seeded variables
(``test_torch_raft._seeded_variables``, bridged by
``weights.raft_state_dict_from_jax``): the loss, every gradient leaf
(norm-wise), the updated parameters and the context net's BatchNorm
statistics, each within ``FLOOR_FACTOR`` times JAX's own floor, measured
and taken as in ``test_torch_bf16_train.py`` (one bf16 ulp changed at 0.1%
of the left image, three times; the reference's bias gradients summed in
float32, as the port sums them; a statistic's floor at least one bf16 ulp of
its step). The biases of the convs a norm takes have a gradient that is
rounding noise on both sides. On these inputs the port reached 0.47 of the
floor for the loss, 1.40 for the worst gradient leaf (the feature net's
first residual conv: its routed convs round a conv and its bias once, as
the kernel does, where XLA on the CPU rounds twice; with every FusedConv
unrouted the worst leaf is at 1.07), 1.07 for the updated parameters and
1.17 for the worst statistic; its noise biases reached 5.4e-3 of their
kernels' gradients, JAX's 7.6e-3.

On the CPU the JAX model runs its fused convs as XLA convs
(``stereoformer_tpu/nn/blocks.py``), whose gradients autodiff derives; the
port runs its fused op, whose bf16 backward is the hand-written
``fused_conv_backward`` with the plain versions of the dx conv and the dw
kernel inside. The Pallas VJPs themselves are held against the port's in
``test_torch_bf16_train_ops.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from test_torch_bf16_train import (  # noqa: E402
    check_within_floor,
    jax_bf16_steps,
    port_bf16_step,
)
from test_torch_raft import _seeded_variables  # noqa: E402
from test_torch_raft_train import _NORM_FED, _port_tree  # noqa: E402
from test_torch_train import _flat  # noqa: E402

from stereoformer_tpu.models.raft_stereo import (  # noqa: E402
    RAFTStereo as JaxRAFTStereo,
)
from stereoformer_tpu_torch import ops  # noqa: E402
from stereoformer_tpu_torch.models import RAFTStereo  # noqa: E402
from stereoformer_tpu_torch.weights import raft_state_dict_from_jax  # noqa: E402

B, H, W, LR = 2, 64, 128, 1e-3


def _norm_fed(key):
    return any(p.search(key) for p in _NORM_FED[False])


def test_raft_bf16_train_step_matches_jax():
    rng = np.random.default_rng(0)
    left = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    right = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    gt = (6 + 3 * rng.standard_normal((B, H, W, 1))).astype(np.float32)
    batch = {"img_left": left, "img_right": right, "gt_disp": gt}
    jmodel = JaxRAFTStereo(dtype=jnp.bfloat16)
    shapes = jax.eval_shape(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, iters=1,
                                 train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)
    runs = jax_bf16_steps(jmodel, variables, batch, LR)

    model = RAFTStereo(dtype=torch.bfloat16)
    model.load_state_dict(raft_state_dict_from_jax(variables))
    n = ops.conv2d_fused.bf16_launches, ops.conv2d_dw.bf16_launches
    state, metrics = port_bf16_step(model, batch, LR)
    # the CPU takes the plain versions of the fused conv, its dx and dw
    assert (ops.conv2d_fused.bf16_launches,
            ops.conv2d_dw.bf16_launches) == n
    assert state.step == 1 and state.opt_state.count == 1
    tree = _port_tree(state.model)
    grads = _flat(_port_tree(state.model, grads=True)["params"])
    check_within_floor(runs, metrics, grads, _flat(tree["params"]),
                       _flat(tree["batch_stats"]), variables["batch_stats"],
                       _norm_fed)
