"""The port's CrossAttentionStereo and its ops against the JAX package, on
the CPU.

``gwc_volume``, ``banded_attention_scores`` and ``banded_attention`` in value
and gradient on seeded inputs with an odd W and D > W/2; the model's eval
outputs and one "sequence" train step from seeded JAX variables bridged
through ``weights.cross_attention_state_dict_from_jax`` (the eval at the
tolerance of ``tests/test_torch_lowcnn.py``, the step at those of
``tests/test_torch_lowcnn_family_train.py``); the bridge's key coverage, the
AMSGrad state's, and the registry entry.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

torch.set_num_threads(1)

from test_torch_lowcnn import TOL_PX, _seeded_variables  # noqa: E402
from test_torch_train import (  # noqa: E402
    _check_updated_params,
    _record_grads,
)

from stereoformer_tpu import ops as jops  # noqa: E402
from stereoformer_tpu.models import (  # noqa: E402
    CrossAttentionStereo as JaxCrossAttentionStereo,
)
from stereoformer_tpu.train import TrainState as JaxTrainState  # noqa: E402
from stereoformer_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from stereoformer_tpu_torch import ops, train  # noqa: E402
from stereoformer_tpu_torch.models import (  # noqa: E402
    CrossAttentionStereo,
    get_model,
)
from stereoformer_tpu_torch.weights import (  # noqa: E402
    amsgrad_state_from_jax,
    cross_attention_state_dict_from_jax,
    state_dict_from_jax,
)

# the model at the JAX package's own test width (tests/test_train.py)
MODEL_KW = {"num_heads": 4, "qk_dim": 32, "gru_hidden": 16}
EVAL_ITERS, TRAIN_ITERS, LR = 3, 2, 1e-3
# the ops: float32 sums of up to 16 products in other orders
OPS_ATOL = 1e-5
# the train step, as tests/test_torch_lowcnn_family_train.py holds LowCNN's:
# the backbone's ~20 ReLU kinks (3e-2 norm-wise; 7.9e-5 measured here);
# past it the leaves that feed a ReLU take the same kinks, 32 GRU channels
# wide: 1.58e-3 measured on the mask head's first conv (mask.0), 1.6e-4 on
# the guidance encoders, the rest below; the BatchNorm-fed conv biases,
# whose gradient is float32 noise, held to 1e-4 of their conv's largest
# weight gradient
BACKBONE = ("conv1.", "conv2.", "conv3.", "downsample", "feature_concated.")
BACKBONE_GRAD_RTOL = 3e-2
REFINE_GRAD_RTOL = 2e-3
GRAD_NORM_RTOL = 3e-4
_BN_FED_BIAS = re.compile(
    r"^(conv[23]|downsample\d|agg\.\d)\.(conv[12]|shortcut\.0)\.bias$")
BN_FED_BIAS_RTOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def qkv():
    """q, k [2, 3, 13, 8], v [2, 3, 13, 6]; W = 13 is odd and D = 9 > W/2."""
    rng = np.random.default_rng(3)
    return tuple(rng.standard_normal((2, 3, 13, c)).astype(np.float32)
                 for c in (8, 8, 6))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_gwc_volume_matches_jax(qkv, groups):
    left, right, _ = qkv
    want = _np(jops.gwc_volume(jnp.asarray(left), jnp.asarray(right), 9,
                               groups))
    got = ops.gwc_volume(_t(left), _t(right), 9, groups).numpy()
    assert got.shape == want.shape == (2, 3, 13, 9, groups)
    np.testing.assert_allclose(got, want, rtol=0, atol=OPS_ATOL)
    # zero where w < d
    assert not got[:, :, 3, 4:].any()


def test_gwc_volume_wider_band_than_image(qkv):
    """D = 16 > W = 13: the bins past W are zero, as in JAX."""
    left, right, _ = qkv
    want = _np(jops.gwc_volume(jnp.asarray(left), jnp.asarray(right), 16, 2))
    got = ops.gwc_volume(_t(left), _t(right), 16, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OPS_ATOL)
    assert not got[..., 13:, :].any()
    with pytest.raises(ValueError, match="multiple of num_groups"):
        ops.gwc_volume(_t(left), _t(right), 4, 3)


@pytest.mark.parametrize("heads", [1, 2])
def test_banded_attention_scores_match_jax(qkv, heads):
    q, k, _ = qkv
    want = _np(jops.banded_attention_scores(jnp.asarray(q), jnp.asarray(k), 9,
                                            heads))
    got = ops.banded_attention_scores(_t(q), _t(k), 9, heads).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OPS_ATOL)


@pytest.mark.parametrize("heads", [1, 2])
def test_banded_attention_matches_jax_in_value_and_gradient(qkv, heads):
    """Scores and attended value, and the gradient of a weighted sum of both
    with respect to q, k and v: finite everywhere, the -inf-masked columns
    at w = 0 (only d = 0 in band) included."""
    q, k, v = qkv
    rng = np.random.default_rng(4)
    ws = rng.standard_normal((2, 3, 13, 9, heads)).astype(np.float32)
    wa = rng.standard_normal(v.shape).astype(np.float32)

    def jax_loss(q, k, v):
        s, a = jops.banded_attention(q, k, v, 9, heads)
        return (s * ws).sum() + (a * wa).sum(), (s, a)

    (_, (js, ja)), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    s, a = ops.banded_attention(tq, tk, tv, 9, heads)
    np.testing.assert_allclose(s.detach().numpy(), _np(js), rtol=0,
                               atol=OPS_ATOL)
    np.testing.assert_allclose(a.detach().numpy(), _np(ja), rtol=0,
                               atol=OPS_ATOL)
    # w = 0 attends to v[0] alone
    np.testing.assert_allclose(a.detach().numpy()[:, :, 0], v[:, :, 0],
                               rtol=0, atol=1e-6)
    ((s * _t(ws)).sum() + (a * _t(wa)).sum()).backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        got = got.numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, _np(want), rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    left = rng.standard_normal((2, 64, 128, 3)).astype(np.float32)
    right = rng.standard_normal((2, 64, 128, 3)).astype(np.float32)
    gt = (20 + 5 * rng.standard_normal((2, 64, 128, 1))).astype(np.float32)
    return {"img_left": left, "img_right": right, "gt_disp": gt}


@pytest.fixture(scope="module")
def jax_model_variables(batch):
    model = JaxCrossAttentionStereo(**MODEL_KW)
    shapes = jax.eval_shape(
        lambda a, b: model.init(jax.random.PRNGKey(0), a, b, iters=1,
                                train=False),
        batch["img_left"], batch["img_right"])
    return model, _seeded_variables(shapes, seed=1)


def _port_model(variables):
    model = CrossAttentionStereo(**MODEL_KW)
    model.load_state_dict(cross_attention_state_dict_from_jax(variables),
                          strict=True)
    return model


def test_cross_attention_eval_matches_jax(jax_model_variables, batch):
    model, variables = jax_model_variables
    want = jax.jit(lambda v, a, b: model.apply(v, a, b, iters=EVAL_ITERS,
                                               train=False))(
        variables, batch["img_left"], batch["img_right"])
    port = _port_model(variables).eval()
    with torch.inference_mode():
        got = port(_t(batch["img_left"]), _t(batch["img_right"]),
                   iters=EVAL_ITERS)
    np.testing.assert_allclose(got["disp_low"].numpy(), _np(want["disp_low"]),
                               rtol=0, atol=TOL_PX)
    assert len(got["disparities"]) == len(want["disparities"]) == EVAL_ITERS
    for g, w in zip(got["disparities"], want["disparities"]):
        assert g.shape == (2, 64, 128, 1)
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=TOL_PX)
    # the disparities are not constant: the check above compares something
    assert float(got["disparities"][-1].std()) > 0.1


def _check_grads(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if _BN_FED_BIAS.search(k):
            atol = BN_FED_BIAS_RTOL * np.abs(want[k[:-4] + "weight"]).max()
            assert np.abs(g).max() <= atol, k
            assert np.abs(w).max() <= atol, k
            continue
        rtol = BACKBONE_GRAD_RTOL if k.startswith(BACKBONE) else \
            REFINE_GRAD_RTOL
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= rtol, (k, err)


def test_cross_attention_train_step_matches_jax(jax_model_variables, batch):
    """One "sequence" step (AMSGrad lr 1e-3, 2 iterations) against JAX's:
    loss, EPE, gradient norm, every gradient leaf, the updated parameters,
    the BatchNorm statistics, and JAX's AMSGrad state carried into the
    port (``amsgrad_state_from_jax``) against the port's own."""
    model, variables = jax_model_variables
    tx = optax.chain(_record_grads(), optax.amsgrad(LR))
    step = jax_make_train_step(model, tx, "sequence", iters=TRAIN_ITERS)
    jstate = JaxTrainState(step=jnp.asarray(0, jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    jstate, jm = jax.tree_util.tree_map(np.asarray, step(jstate, batch))

    port = _port_model(variables)
    ptx = train.Amsgrad(LR)
    state, m = train.make_train_step(ptx, "sequence", iters=TRAIN_ITERS)(
        train.TrainState.create(port, ptx),
        {k: _t(v) for k, v in batch.items()})
    m = {k: float(v) for k, v in m.items()}
    assert state.step == 1 and state.opt_state.count == 1
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["epe"], jm["epe"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                               rtol=GRAD_NORM_RTOL)

    grads_port = {k: p.grad.numpy() for k, p in port.named_parameters()}
    grads_jax = {k: v.numpy() for k, v in cross_attention_state_dict_from_jax(
        {"params": jstate.opt_state[0]}).items()}
    _check_grads(grads_port, grads_jax)
    assert np.abs(grads_port["proj_q.weight"]).max() > 0

    want = {k: v.numpy() for k, v in cross_attention_state_dict_from_jax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}).items()}
    got = {k: v.numpy() for k, v in port.state_dict().items()}
    before = {k: v.numpy() for k, v in cross_attention_state_dict_from_jax(
        variables).items()}
    _check_updated_params({k: got[k] for k in grads_port},
                          {k: want[k] for k in grads_port}, before,
                          grads_port, grads_jax)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(k.endswith("running_mean") for k in got)
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)

    carried = amsgrad_state_from_jax(jstate.opt_state, port)
    assert carried.count == 1
    for name in ("mu", "nu", "nu_max"):
        mine, theirs = getattr(state.opt_state, name), getattr(carried, name)
        assert sorted(mine) == sorted(theirs) == sorted(grads_port)
    # the first moment after one step is 0.1 g
    for k in grads_port:
        np.testing.assert_allclose(carried.mu[k].numpy(),
                                   0.1 * grads_jax[k], rtol=1e-6,
                                   atol=1e-12, err_msg=k)


def test_bridge_lands_every_jax_leaf_in_one_port_key(jax_model_variables):
    """Every element of every JAX leaf (parameters and BatchNorm statistics)
    is written to exactly one element of the port's state_dict, and every
    port entry comes from one: the JAX elements are numbered 0, 1, ...,
    each number bridged as two float32-exact halves, and the port's
    entries hold each number once."""
    _, variables = jax_model_variables
    count = [0]

    def number(node):
        if hasattr(node, "items"):
            return {k: number(v) for k, v in node.items()}
        n = int(np.prod(node.shape))
        out = np.arange(count[0], count[0] + n).reshape(node.shape)
        count[0] += n
        return out

    def part(tree, fn):
        if hasattr(tree, "items"):
            return {k: part(v, fn) for k, v in tree.items()}
        return fn(tree).astype(np.float32)

    numbered = number(variables)
    assert count[0] < 2 ** 36
    hi = cross_attention_state_dict_from_jax(part(numbered,
                                                  lambda a: a >> 12))
    lo = cross_attention_state_dict_from_jax(part(numbered,
                                                  lambda a: a & 4095))
    port = CrossAttentionStereo(**MODEL_KW).state_dict()
    assert sorted(hi) == sorted(port)
    keys = [k for k in port if not k.endswith("num_batches_tracked")]
    values = np.concatenate([
        hi[k].numpy().astype(np.int64).ravel() * 4096
        + lo[k].numpy().astype(np.int64).ravel() for k in keys])
    np.testing.assert_array_equal(np.sort(values), np.arange(count[0]))
    for k, v in port.items():
        assert tuple(hi[k].shape) == tuple(v.shape), k
    # the dispatcher picks this map by name
    by_name = state_dict_from_jax("CrossAttentionStereo",
                                  part(numbered, lambda a: a >> 12))
    for k, v in hi.items():
        assert torch.equal(by_name[k], v), k
    with pytest.raises(ValueError, match="unknown model"):
        state_dict_from_jax("PSMNet", variables)


def test_registry_builds_cross_attention():
    """The registry entry drops ``loop`` and ``scan_unroll`` as JAX's does;
    bf16 builds and takes the float32 state dict, float16 raises; the
    seeded weights repeat."""
    a = get_model("CrossAttentionStereo", device="cpu", loop="scan",
                  scan_unroll=2, **MODEL_KW)
    b = get_model("CrossAttentionStereo", device="cpu", **MODEL_KW)
    assert isinstance(a, CrossAttentionStereo) and not a.training
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    bf16 = CrossAttentionStereo(dtype=torch.bfloat16, **MODEL_KW)
    bf16.load_state_dict(b.state_dict(), strict=True)
    assert all(v.dtype != torch.bfloat16 for v in bf16.state_dict().values())
    with pytest.raises(NotImplementedError, match="float16"):
        CrossAttentionStereo(dtype=torch.float16)
    with pytest.raises(ValueError, match="upsample"):
        CrossAttentionStereo(upsample="bilinear")


def test_cli_train_runs_cross_attention(tmp_path):
    """cli.train --net CrossAttentionStereo trains with its trainer's
    default loss ("sequence") and writes its checkpoints, with no
    model-specific code in the trainer."""
    from stereoformer_tpu_torch.cli.train import main as train_main
    from stereoformer_tpu_torch.train import checkpoint_meta

    outf = tmp_path / "models"
    trainer = train_main([
        "--net", "CrossAttentionStereo", "--dataset", "dummy:4",
        "--epochs", "1", "--crop_h", "32", "--crop_w", "64",
        "--batch_size", "2", "--test_batch", "2", "--train_iters", "2",
        "--eval_iters", "2", "--workers", "0", "--device", "cpu",
        "--outf", str(outf), "--save_logdir", str(tmp_path / "logs")])
    assert trainer.loss_name == "sequence"
    assert trainer.state.step == 2 and trainer.state.opt_state.count == 2
    assert np.isfinite(trainer.history[-1]["loss"])
    names = sorted(os.listdir(outf))
    assert "model_best" in names
    (ckpt,) = [n for n in names if n.startswith("CrossAttentionStereo_0_0_")]
    assert checkpoint_meta(str(outf / ckpt))["arch"] == "CrossAttentionStereo"
