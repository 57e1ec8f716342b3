"""The checkpoint bridge ``scripts/jax_ckpt_to_torch.py`` for the models
beside LowCNN_gru (whose whole state ``tests/test_torch_cli_eval.py``
holds bit for bit), on the CPU: JAX states written with the JAX package's
``save_checkpoint``, bridged, and read by the port's ``restore_params``.
The helpers here write and bridge the JAX checkpoints of both files.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

torch.set_num_threads(1)

from test_torch_lowcnn import _seeded_variables  # noqa: E402

from stereoformer_tpu.models import get_model as jax_get_model  # noqa: E402
from stereoformer_tpu.train import TrainState as JaxTrainState  # noqa: E402
from stereoformer_tpu.train.checkpoint import (  # noqa: E402
    finalize_checkpoints as jax_finalize_checkpoints,
)
from stereoformer_tpu.train.checkpoint import (  # noqa: E402
    save_checkpoint as jax_save_checkpoint,
)
from stereoformer_tpu_torch.models import get_model  # noqa: E402
from stereoformer_tpu_torch.train import TrainState, restore_params  # noqa: E402
from stereoformer_tpu_torch.weights import state_dict_from_jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = ["--crop_h", "64", "--crop_w", "128"]


def _load_bridge():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts",
                                          "jax_ckpt_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bridge = _load_bridge()


def _seeded_state(name, seed, optimizer="amsgrad"):
    """A JAX TrainState of registry model ``name``: seeded variables, step
    7, and the JAX trainer's AMSGrad state with seeded moments and count 7
    (or, with ``optimizer="adam"``, another optimizer's state)."""
    model = jax_get_model(name)
    x = np.zeros((1, 64, 128, 3), np.float32)
    shapes = jax.eval_shape(lambda a, b: model.init(
        jax.random.PRNGKey(0), a, b, iters=1, train=False), x, x)
    variables = _seeded_variables(shapes, seed=seed)
    params = variables["params"]
    if optimizer == "adam":
        opt_state = optax.adam(1e-3).init(params)
    else:
        rng = np.random.default_rng(seed + 100)

        def moment(scale, positive=False):
            def draw(p):
                z = rng.standard_normal(np.shape(p))
                return (scale * (np.abs(z) if positive else z)).astype(
                    np.float32)
            return jax.tree_util.tree_map(draw, params)

        ams, sched = optax.amsgrad(lambda count: 1e-3).init(params)
        nu = moment(1e-4, positive=True)
        ams = ams._replace(
            count=jnp.asarray(7, jnp.int32), mu=moment(1e-2), nu=nu,
            nu_max=jax.tree_util.tree_map(lambda a: 1.5 * a, nu))
        opt_state = (ams, sched._replace(count=jnp.asarray(7, jnp.int32)))
    return JaxTrainState(step=jnp.asarray(7, jnp.int32), params=params,
                         batch_stats=variables["batch_stats"],
                         opt_state=opt_state)


def _save_jax(root, name, state):
    """The JAX package's save_checkpoint (asynchronous: finalized before
    anything reads it); returns model_best."""
    jax_save_checkpoint(str(root), state, name, 0, 3, 1.234, True)
    jax_finalize_checkpoints()
    return os.path.join(str(root), "model_best")


def _bridge(jax_ckpt, name, out):
    return bridge.main(["--net", name, "--ckpt", jax_ckpt, "--out", out]
                       + CROP)


@pytest.mark.parametrize("name, optimizer", [
    ("RAFT_Stereo", "adam"), ("CrossAttentionStereo", "amsgrad")])
def test_bridge_reads_other_models(tmp_path, name, optimizer, capsys):
    """RAFT_Stereo (its checkpoint from another optimizer's run: restored
    with restore_params, a fresh AMSGrad state written) and
    CrossAttentionStereo (with its AMSGrad state), read by the port's
    restore_params: the model and the step bit-equal to the bridge's."""
    state = _seeded_state(name, seed=5, optimizer=optimizer)
    out = _bridge(_save_jax(tmp_path / "jax", name, state), name,
                  str(tmp_path / "port.pt"))
    said = capsys.readouterr().out
    assert ("a fresh" if optimizer == "adam" else "with its") in said
    state = jax.tree_util.tree_map(np.asarray, state)
    got = restore_params(out, TrainState(
        step=0, model=get_model(name, device="cpu"), opt_state=None))
    want = state_dict_from_jax(name, {"params": state.params,
                                      "batch_stats": state.batch_stats})
    assert got.step == 7
    assert sorted(got.model.state_dict()) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got.model.state_dict()[k], v), k
    ck = torch.load(out, map_location="cpu", weights_only=True)
    assert sorted(ck) == ["meta", "model", "opt_state", "step"]
    assert ck["opt_state"]["count"] == (0 if optimizer == "adam" else 7)
    shutil.rmtree(tmp_path, ignore_errors=True)
