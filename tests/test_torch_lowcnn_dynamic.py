"""The port's learned-bounds LowCNN variants against the JAX models, on the
CPU: ``LowCNN_dynamic`` (``refinement="learned"``, loss "equal") and
``LowCNN_dynamic_supervised`` (``"learned_supervised"``, loss
"range_supervised").

Both run at the small shapes of ``tests/test_torch_lowcnn.py`` (64x256,
B=2) from seeded JAX variables bridged through
``weights.lowcnn_state_dict_from_jax``: the eval outputs; one train step
against JAX's ``make_train_step`` (loss, EPE, gradient norm, every gradient
leaf, BatchNorm statistics, updated parameters); one step from JAX's own
init, whose zero offset conv puts every deformable offset at exactly 0,
where JAX's offset gradient is exactly 0; and a JAX run carried on through
``weights.amsgrad_state_from_jax``. Also the registry, the weight keys, the
eval and inference steps and the CLI.
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
from stereoformer_tpu_torch.models import (  # noqa: E402
    LowCNN,
    available_models,
    get_model,
)
from stereoformer_tpu_torch.weights import (  # noqa: E402
    amsgrad_state_from_jax,
    lowcnn_state_dict_from_jax,
)

LR = 1e-3
# refinement -> (registry name, the trainer's default loss,
# stereoformer_tpu/train/trainer.py:49-50)
VARIANTS = {"learned": ("LowCNN_dynamic", "equal"),
            "learned_supervised": ("LowCNN_dynamic_supervised",
                                   "range_supervised")}
# f32 on both sides, summed in other orders through ~25 convs and one
# refinement; 1e-3 px is the stated bound (as for LowCNN_gru)
TOL_PX = 1e-3
# Conv biases followed by a train-mode BatchNorm (the DeformConv's too):
# their gradient is 0 in exact arithmetic, float32 noise on both sides
_BN_FED_BIAS = re.compile(r"(^|\.)(conv[12]|shortcut\.0)\.bias$")
BN_FED_BIAS_ATOL = 1e-4
# Norm-wise relative error per leaf. The leaves whose gradient passes
# through the deformable offsets (the backbone, the aggregation, the offset
# net before its deformable conv, and the offset conv) take a kink: the
# windowed sampler's offset gradient jumps where an offset crosses an
# integer, and the float32 offsets of the two sides differ by up to ~6e-5
# px (measured against a float64 run of the port). In the supervised
# variant's step one of the 9216 offsets lies 1.9e-5 px from 0 and lands on
# the other side of it in the port than in JAX, which moves those leaves by
# up to 1.7% (0.2% in the unsupervised variant); the backbone's own ReLU
# kinks alone give ~1% (tests/test_torch_train.py).
_PAST_THE_OFFSETS = ("upsample_mask.", "local_cost_volume.unet.conv.",
                     "local_cost_volume.unet.deformblock.bn2.",
                     "local_cost_volume.unet.deformblock.shortcut.",
                     "local_cost_volume.unet.deformblock.conv2.weight",
                     "local_cost_volume.unet.deformblock.conv2.bias")
# past the offsets: sums over the 2x8x32 pixels of products of forward
# values that agree to ~1e-5 (1.1e-4 measured, the deform block's shortcut)
HEAD_GRAD_RTOL = 3e-4
KINK_GRAD_RTOL = 3e-2
# the global norm is dominated by the backbone's leaves: 5.9e-4 measured
GRAD_NORM_RTOL = 2e-3


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    left = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    right = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    gt = (40 + 10 * rng.standard_normal((2, 64, 256, 1))).astype(np.float32)
    return {"img_left": left, "img_right": right, "gt_disp": gt}


@pytest.fixture(scope="module")
def jax_runs(batch):
    """refinement -> {"variables", "eval", "steps": [(state, metrics)] x 2,
    "init": (the JAX init's variables, (state, metrics) of one step from
    them)}, as numpy."""
    left, right = batch["img_left"], batch["img_right"]
    # the two variants share one parameter tree (``relative`` changes only
    # the arithmetic): one init serves both
    init_vars = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda a, b: JaxLowCNN(refinement="learned").init(
            jax.random.PRNGKey(0), a, b, train=False))(left, right))
    runs = {}
    for refinement, (_, loss) in VARIANTS.items():
        model = JaxLowCNN(refinement=refinement)
        variables = _seeded_variables(init_vars, seed=1)
        out = jax.jit(lambda v, a, b, m=model: m.apply(v, a, b, train=False))(
            variables, left, right)
        tx = optax.chain(_record_grads(), optax.amsgrad(LR))
        step = jax_make_train_step(model, tx, loss, iters=1)

        def run(v, n):
            state = JaxTrainState(step=jnp.asarray(0, jnp.int32),
                                  params=v["params"],
                                  batch_stats=v["batch_stats"],
                                  opt_state=tx.init(v["params"]))
            done = []
            for _ in range(n):
                state, m = step(state, batch)
                # to numpy before the next step donates the state
                done.append(jax.tree_util.tree_map(np.asarray, (state, m)))
            return done

        runs[refinement] = {
            "variables": variables,
            "eval": jax.tree_util.tree_map(np.asarray, out),
            "steps": run(variables, 2),
            "init": (init_vars, run(init_vars, 1)[0])}
    return runs


def _port_model(refinement, variables):
    model = LowCNN(refinement=refinement)
    model.load_state_dict(lowcnn_state_dict_from_jax(variables), strict=True)
    return model


def _port_step(refinement, variables, batch, opt_state=None, step=0):
    model = _port_model(refinement, variables)
    tx = train.Amsgrad(LR)
    state = train.TrainState.create(model, tx)
    if opt_state is not None:
        state.opt_state = amsgrad_state_from_jax(opt_state, model)
        state.step = step
    train_step = train.make_train_step(tx, VARIANTS[refinement][1], iters=1)
    state, m = train_step(state, {k: _t(v) for k, v in batch.items()})
    return state, {k: float(v) for k, v in m.items()}


def _grads(model) -> dict:
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


def _jax_grads(opt_state) -> dict:
    """The JAX step's gradients (``opt_state[0]``, see _record_grads) under
    the port's keys."""
    return {k: v.numpy() for k, v in lowcnn_state_dict_from_jax(
        {"params": opt_state[0]}).items()}


def _check_grads(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if _BN_FED_BIAS.search(k):
            assert np.abs(g).max() <= BN_FED_BIAS_ATOL, k
            assert np.abs(w).max() <= BN_FED_BIAS_ATOL, k
            continue
        rtol = HEAD_GRAD_RTOL if k.startswith(_PAST_THE_OFFSETS) else \
            KINK_GRAD_RTOL
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= rtol, (k, err)


def _check_metrics(got, want):
    # float32 losses of ~40 px over 32768 pixels and 2 outputs
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["epe"], want["epe"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GRAD_NORM_RTOL)


@pytest.mark.parametrize("refinement", list(VARIANTS))
def test_eval_matches_jax(jax_runs, batch, refinement):
    run = jax_runs[refinement]
    want = run["eval"]
    model = _port_model(refinement, run["variables"]).eval()
    with torch.inference_mode():
        got = model(_t(batch["img_left"]), _t(batch["img_right"]), iters=7)
    assert len(got["disparities"]) == len(want["disparities"]) == 2
    for g, w in zip(got["disparities"], want["disparities"]):
        assert g.shape == w.shape == (2, 64, 256, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL_PX)
    np.testing.assert_allclose(got["disp_low"].numpy(), want["disp_low"],
                               rtol=0, atol=TOL_PX)
    assert ("bounds" in got) == ("bounds" in want)
    for g, w in zip(got.get("bounds", ()), want.get("bounds", ())):
        assert g.shape == w.shape == (2, 8, 32, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL_PX)
    # the refinement changed the disparity: the learned bounds did work
    assert not np.allclose(want["disparities"][0], want["disparities"][1])


@pytest.mark.parametrize("refinement", list(VARIANTS))
def test_train_step_matches_jax(jax_runs, batch, refinement):
    """Loss, EPE, gradient norm, every gradient leaf (each parameter
    reaches the loss: a None gradient would fail here and in AMSGrad), the
    BatchNorm statistics and the updated parameters."""
    run = jax_runs[refinement]
    variables = run["variables"]
    jstate, jm = run["steps"][0]
    state, m = _port_step(refinement, variables, batch)
    assert state.step == 1 and state.opt_state.count == 1
    _check_metrics(m, jm)
    grads_port, grads_jax = _grads(state.model), _jax_grads(jstate.opt_state)
    _check_grads(grads_port, grads_jax)

    want = {k: v.numpy() for k, v in lowcnn_state_dict_from_jax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}).items()}
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    params = dict(state.model.named_parameters())
    before = {k: v.numpy() for k, v in lowcnn_state_dict_from_jax(
        variables).items()}
    _check_updated_params({k: got[k] for k in params},
                          {k: want[k] for k in params},
                          before, grads_port, grads_jax)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert any("deformblock" in k for k in stats)
    for k in stats:
        # float32 batch moments
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("refinement", list(VARIANTS))
def test_step_from_jax_init_has_zero_offset_gradient(jax_runs, batch,
                                                     refinement):
    """From JAX's own init the offset conv is zero, so every offset is
    exactly 0: JAX's hat then passes no gradient to the offsets, and the
    offset half of the offset conv gets exactly none, on both sides; its
    mask half does get one."""
    init_vars, (jstate, jm) = jax_runs[refinement]["init"]
    dcn = init_vars["params"]["LearnedBounds_0"]["SmallUNet_0"][
        "DeformBlock_0"]["DeformConv_0"]["offset_mask"]
    assert not np.any(dcn["kernel"]) and not np.any(dcn["bias"])
    state, m = _port_step(refinement, init_vars, batch)
    _check_metrics(m, jm)
    key = "local_cost_volume.unet.deformblock.conv2.conv_offset_mask."
    grads_port, grads_jax = _grads(state.model), _jax_grads(jstate.opt_state)
    for leaf in ("weight", "bias"):
        got, want = grads_port[key + leaf], grads_jax[key + leaf]
        assert not want[:18].any() and not got[:18].any(), leaf
        assert np.abs(want[18:]).max() > 0, leaf
        err = np.linalg.norm(got[18:] - want[18:]) / np.linalg.norm(want[18:])
        assert err <= HEAD_GRAD_RTOL, (leaf, err)


@pytest.mark.parametrize("refinement", list(VARIANTS))
def test_amsgrad_state_from_jax_continues_a_jax_run(jax_runs, batch,
                                                    refinement):
    """JAX's state after one step (parameters, BatchNorm statistics, the
    AMSGrad moments and count) carried into the port; the second step on
    both sides."""
    (jstate1, _), (jstate2, jm2) = jax_runs[refinement]["steps"]
    carried = {"params": jstate1.params, "batch_stats": jstate1.batch_stats}
    state, m = _port_step(refinement, carried, batch,
                          opt_state=jstate1.opt_state, step=1)
    assert state.step == 2 and state.opt_state.count == 2
    _check_metrics(m, jm2)
    _check_grads(_grads(state.model), _jax_grads(jstate2.opt_state))
    # the first moment after step 2, 0.9 mu_1 + 0.1 g_2
    want_mu = {k: v.numpy() for k, v in lowcnn_state_dict_from_jax(
        {"params": jstate2.opt_state[1][0].mu}).items()}
    _check_grads({k: v.numpy() for k, v in state.opt_state.mu.items()},
                 want_mu)


@pytest.mark.parametrize("refinement", list(VARIANTS))
def test_registry_and_seeded_weights(refinement):
    """The registry builds the variant; its seeded offset conv is zero, as
    JAX's init, and its deformable weight he-normal over fan-in."""
    name = VARIANTS[refinement][0]
    model = get_model(name, device="cpu")
    assert model.refinement == refinement
    sd = model.state_dict()
    key = "local_cost_volume.unet.deformblock.conv2."
    assert not sd[key + "conv_offset_mask.weight"].any()
    assert not sd[key + "conv_offset_mask.bias"].any()
    w = sd[key + "weight"]
    assert w.shape == (16, 16, 3, 3)
    assert 0.5 < float(w.std() / np.sqrt(2.0 / 144)) < 1.5
    assert "upsample_mask.upsample_mask.2.weight" in sd
    assert name in available_models()


def test_unported_refinement_raises():
    """Every refinement of the JAX family is ported now, in float32 and
    bf16 (which takes the float32 state dict); a dtype the port does not
    compute in (float16) raises, and so does an unknown refinement."""
    bf16 = LowCNN(refinement="learned", dtype=torch.bfloat16)
    bf16.load_state_dict(LowCNN(refinement="learned").state_dict(),
                         strict=True)
    with pytest.raises(NotImplementedError, match="float16"):
        LowCNN(refinement="learned", dtype=torch.float16)
    with pytest.raises(ValueError, match="unknown refinement"):
        LowCNN(refinement="learned_bogus")


def test_eval_and_infer_steps_take_the_refined_disparity(jax_runs, batch):
    run = jax_runs["learned_supervised"]
    model = _port_model("learned_supervised", run["variables"])
    state = train.TrainState.create(model, train.Amsgrad(LR))
    left, right = _t(batch["img_left"]), _t(batch["img_right"])
    pred = train.make_infer_fn()(state, left, right)
    np.testing.assert_allclose(pred.numpy(), run["eval"]["disparities"][1],
                               rtol=0, atol=TOL_PX)
    got = train.make_eval_step()(state, {"img_left": left,
                                         "img_right": right,
                                         "gt_disp": _t(batch["gt_disp"])})
    torch.testing.assert_close(got["pred"], pred)


def test_infer_cli_runs_the_learned_bounds(tmp_path):
    from PIL import Image

    from stereoformer_tpu_torch.cli.infer import main

    rng = np.random.default_rng(5)
    paths = []
    for side in ("left", "right"):
        img = rng.integers(0, 256, (60, 124, 3), dtype=np.uint8)
        paths.append(tmp_path / f"{side}.png")
        Image.fromarray(img).save(paths[-1])
    out = tmp_path / "disp.npy"
    disp = main(["--left", str(paths[0]), "--right", str(paths[1]),
                 "--out", str(out), "--device", "cpu", "--net",
                 "LowCNN_dynamic_supervised"])
    assert disp.shape == (60, 124)
    assert np.isfinite(disp).all()
