#!/usr/bin/env python3
"""How far one float32 RAFT-Stereo train step lands from a float64 one, at
the update block's convs whose output passes a ReLU, on each side: the
PyTorch port's float32 step and the JAX package's float32 step, each
against the JAX package's float64 step from the same seeded variables.

    JAX_PLATFORMS=cpu python scripts/raft_kink_readings.py ds1:0 hidden96:2

Each argument is ``SET:SEED``: an option set of
``tests/test_torch_raft_options.py`` (``default``, ``ds3_gru2``, ``ds1``,
``gru1_corr2r3``, ``hidden96``) and a seed. Seed 0 is
``tests/test_torch_raft_options_train.py``'s (data seed 0, weights seed 1);
another seed s draws the data from s and the weights from 11. The step is
that test's (64x128, B=2, 2 iterations, the sequence loss, AMSGrad 1e-3).
Prints one JSON line per argument: each leaf's norm-wise relative distance
of the port's and JAX's float32 gradient from JAX's float64 gradient. The
float32 steps run in a child process without ``jax_enable_x64`` (under it
some of JAX's float32 step would promote to float64), the port's on one
thread as the test runs it (its sums' order moves with the thread count,
and with it which ReLU inputs near 0 fall on which side). It runs on the
CPU, where JAX and the port both are; the test file's comment on
``KINK_GRAD_RTOL`` quotes its readings.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

# the child that runs the float32 steps: --float32 SET:SEED OUT.npz
CHILD = len(sys.argv) == 4 and sys.argv[1] == "--float32"
jax.config.update("jax_enable_x64", not CHILD)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from test_torch_raft import _seeded_variables  # noqa: E402
from test_torch_raft_options import OPTION_SETS  # noqa: E402
from test_torch_raft_options_train import B, H, ITERS, LR, W, _KINK, _t  # noqa: E402
from test_torch_train import _record_grads  # noqa: E402

from stereoformer_tpu.models.raft_stereo import RAFTStereo as JaxRAFTStereo  # noqa: E402
from stereoformer_tpu.train import TrainState as JaxTrainState  # noqa: E402
from stereoformer_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from stereoformer_tpu_torch import train  # noqa: E402
from stereoformer_tpu_torch.models import RAFTStereo  # noqa: E402
from stereoformer_tpu_torch.weights import raft_state_dict_from_jax  # noqa: E402


def jax_grads(jmodel, variables, batch, dtype) -> dict:
    """JAX's gradient of one step in ``dtype``, in the port's keys."""
    v = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a).astype(dtype)), variables)
    tx = optax.chain(_record_grads(), optax.amsgrad(LR))
    state = JaxTrainState(step=jnp.asarray(0, jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"],
                          opt_state=tx.init(v["params"]))
    step = jax_make_train_step(jmodel, tx, "sequence", iters=ITERS)
    state, _ = step(state, {k: a.astype(dtype) for k, a in batch.items()})
    grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   state.opt_state[0])
    return {k: t.double().numpy()
            for k, t in raft_state_dict_from_jax({"params": grads}).items()}


def port_grads(options, variables, batch) -> dict:
    """The port's float32 gradient of one step."""
    model = RAFTStereo(**options)
    model.load_state_dict(raft_state_dict_from_jax(variables), strict=True)
    tx = train.Amsgrad(LR)
    state = train.TrainState.create(model, tx)
    train.make_train_step(tx, "sequence", iters=ITERS)(
        state, {k: _t(a) for k, a in batch.items()})
    return {k: p.grad.double().numpy() for k, p in model.named_parameters()}


def setup(name: str, seed: int):
    """(options, variables, batch, JAX model) of ``name`` at ``seed``."""
    options = OPTION_SETS[name]
    rng = np.random.default_rng(seed)
    left = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    right = (255 * rng.random((B, H, W, 3))).astype(np.float32)
    gt = (6 + 3 * rng.standard_normal((B, H, W, 1))).astype(np.float32)
    batch = {"img_left": left, "img_right": right, "gt_disp": gt}
    jmodel = JaxRAFTStereo(**options)
    shapes = jax.eval_shape(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, iters=1,
                                 train=False), left, right)
    variables = _seeded_variables(shapes, seed=1 if seed == 0 else 11)
    return options, variables, batch, jmodel


def kink_leaves(grads: dict) -> dict:
    return {k: g for k, g in grads.items()
            if _KINK.fullmatch(k) and k.endswith("weight")}


def float32_steps(spec: str, out: str) -> None:
    """The child: both sides' float32 gradients at the leaves, to ``out``."""
    options, variables, batch, jmodel = setup(*_parse(spec))
    np.savez(out, **{f"port32/{k}": g for k, g in kink_leaves(
        port_grads(options, variables, batch)).items()},
        **{f"jax32/{k}": g for k, g in kink_leaves(
            jax_grads(jmodel, variables, batch, np.float32)).items()})


def readings(spec: str) -> dict:
    options, variables, batch, jmodel = setup(*_parse(spec))
    ref = kink_leaves(jax_grads(jmodel, variables, batch, np.float64))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "float32.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--float32", spec, out], check=True)
        got = dict(np.load(out))
    return {k: {side: float(np.linalg.norm(got[f"{side}/{k}"] - ref[k])
                            / np.linalg.norm(ref[k]))
                for side in ("port32", "jax32")}
            for k in ref}


def _parse(spec: str) -> tuple:
    name, seed = spec.split(":")
    return name, int(seed)


def main() -> int:
    torch.set_num_threads(1)   # as the test runs it
    if CHILD:
        float32_steps(sys.argv[2], sys.argv[3])
        return 0
    for spec in sys.argv[1:]:
        name, seed = _parse(spec)
        print(json.dumps({"set": name, "seed": seed,
                          "from_jax_float64": readings(spec)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
