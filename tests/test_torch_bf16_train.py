"""The port's bf16 training (``get_model(name, dtype=torch.bfloat16)`` under
``train.make_train_step``) against the JAX package's bf16 train step, on the
CPU.

One step of ``LowCNN_gru`` in bf16 (64x256, B=2, two GRU iterations,
sequence loss, AMSGrad lr 1e-3) against JAX's ``make_train_step`` on
``LowCNN(refinement="gru", dtype=jnp.bfloat16)`` from the same seeded
weights: the loss, every gradient leaf (norm-wise), the updated parameters
and the BatchNorm statistics. Parameters, AMSGrad moments and statistics
stay float32 on both sides; a parameter's gradient is the bf16 gradient of
its cast, widened.

A bf16 step is chaotic at the scale of its own rounding, as the bf16
forward is (``test_torch_bf16.py``): JAX against itself, with one bf16 ulp
changed at 0.1% of the left image's values, moves every quantity by as much
as another summation order does. That is JAX's own floor, measured here for
three such changes (seeds ``NUDGE_SEEDS``) and taken at its largest per
quantity; the port is held to ``FLOOR_FACTOR`` times it. The reference's
bf16 sums that autodiff inserts (a bias's gradient) are taken in float32,
as the port takes them (``float32_accumulated_transposes``: XLA on the CPU
would accumulate them in bf16). On these inputs the port reached 1.07 of
the floor for the loss, 1.22 for the worst gradient leaf, 1.05 for the
worst BatchNorm statistic, and 0.95 for the updated parameters (the norm of
their difference over all leaves: AMSGrad's first step moves each by about
lr, so a leaf's difference is the few gradients whose sign flips, and a
leaf's own floor is often 0). A statistic moves by momentum times a batch
moment of bf16 activations; where one bf16 ulp of that step is larger than
the floor (a nudge of the image moves the early norms' moments less than
the rounding of their inputs does), the floor is that ulp. The biases of
the convs a train-mode BatchNorm takes have a gradient that is 0 in exact
arithmetic: on each side it is bf16 rounding noise, and the port's
(relative to the gradient of the conv's kernel) may be no larger than the
largest of JAX's.

Beside it, port only: every registry name takes one bf16 step at a small
size with finite float32 gradients for every parameter and float32
parameters and statistics after it; ``remat`` gives the plain step's
values, and ``freeze_bn`` keeps the statistics, as in float32.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax._src.lax import lax as lax_impl  # noqa: E402

torch.set_num_threads(1)

from test_torch_bf16 import FLOOR_FACTOR, ULP  # noqa: E402
from test_torch_lowcnn import _seeded_variables  # noqa: E402
from test_torch_train import (  # noqa: E402
    _BN_FED_BIAS,
    _flat,
    _port_tree,
    _record_grads,
)

from stereoformer_tpu.models.low_cnn import LowCNN as JaxLowCNN  # noqa: E402
from stereoformer_tpu.train import TrainState as JaxTrainState  # noqa: E402
from stereoformer_tpu.train import make_train_step as jax_make_train_step  # noqa: E402
from stereoformer_tpu_torch import train  # noqa: E402
from stereoformer_tpu_torch.models import LowCNN, available_models, get_model  # noqa: E402
from stereoformer_tpu_torch.weights import lowcnn_state_dict_from_jax  # noqa: E402

BF = torch.bfloat16
ITERS = 2
LR = 1e-3
NUDGE_SEEDS = (9, 10, 11)


def nudged(left, seed):
    """``left`` with one bf16 ulp added at 0.1% of its values."""
    out = left.copy()
    pick = np.random.default_rng(seed).random(left.shape) < 1e-3
    out[pick] *= 1 + ULP
    return out


@contextlib.contextmanager
def float32_accumulated_transposes():
    """The sums that autodiff inserts into a bf16 program (the transposes of
    a broadcast or an implicit broadcast: a bias's gradient, summed over
    every pixel) taken in float32 and rounded to bf16 once, as the port and
    the Pallas VJPs take theirs. As they stand they are bf16 reductions,
    which XLA on the CPU accumulates in bf16, rounding after every add:
    over the thousand pixels of a gradient at 1/4 resolution that is off
    by up to half of the sum
    (``test_xla_cpu_accumulates_bf16_reductions_in_bf16``)."""
    orig = lax_impl.reduce_sum

    def reduce_sum(operand, axes, **kw):
        if jnp.result_type(operand) != jnp.bfloat16:
            return orig(operand, axes, **kw)
        return orig(operand.astype(jnp.float32), axes, **kw).astype(
            jnp.bfloat16)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lax_impl, "reduce_sum", reduce_sum)
        yield


def jax_bf16_steps(model, variables, batch, lr):
    """One JAX train step from ``variables`` on ``batch`` and on each nudged
    batch, as numpy: [(state, metrics)], the plain batch's first; the
    gradients in ``state.opt_state[0]``. Traced and compiled under
    ``float32_accumulated_transposes``."""
    tx = optax.chain(_record_grads(), optax.amsgrad(lr))
    step = jax_make_train_step(model, tx, "sequence", iters=ITERS)
    runs = []
    with float32_accumulated_transposes():
        for left in [batch["img_left"]] + [nudged(batch["img_left"], s)
                                           for s in NUDGE_SEEDS]:
            state = JaxTrainState(step=jnp.asarray(0, jnp.int32),
                                  params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=tx.init(variables["params"]))
            state, m = step(state, {**batch, "img_left": left})
            runs.append(jax.tree_util.tree_map(np.asarray, (state, m)))
    return runs


def port_bf16_step(model, batch, lr, **step_kw):
    tx = train.Amsgrad(lr)
    state = train.TrainState.create(model, tx)
    step = train.make_train_step(tx, "sequence", iters=ITERS, **step_kw)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert m["loss"].dtype == torch.float32
    return state, {k: float(v) for k, v in m.items()}


def _floor(values, want):
    return max(abs(v - want) for v in values)


def check_within_floor(runs, metrics, grads, params, stats, stats_before,
                       noise_bias):
    """The port's loss, gradient leaves (norm-wise), updated parameters (the
    norm over all leaves) and statistics (norm-wise per leaf; moved
    from ``stats_before``) against JAX's plain run, within FLOOR_FACTOR
    times the largest distance of a nudged JAX run from it.
    ``noise_bias(key)`` is true of the biases whose gradient is
    rounding noise: the port's noise, relative to the gradient of the
    conv's kernel, may be no larger than JAX's largest."""
    (jstate, jm), nudges = runs[0], runs[1:]
    floor = _floor([float(m["loss"]) for _, m in nudges], float(jm["loss"]))
    err = abs(metrics["loss"] - float(jm["loss"]))
    print(f"loss: port {metrics['loss']:.4f}, JAX {float(jm['loss']):.4f}, "
          f"{err / floor:.2f} of the floor {floor:.4f}")
    assert err <= FLOOR_FACTOR * floor, (err, floor)

    want = _flat(jstate.opt_state[0])
    others = [_flat(s.opt_state[0]) for s, _ in nudges]
    assert sorted(grads) == sorted(want)

    def noise(g, k):   # relative to the gradient of the conv's kernel
        return np.linalg.norm(g[k]) / np.linalg.norm(
            g[k.replace("['bias']", "['kernel']")])

    noisy = [k for k in want if noise_bias(k)]
    if noisy:
        got = max(noise(grads, k) for k in noisy)
        floor = max(noise(g, k) for g in [want] + others for k in noisy)
        print(f"noise biases: the port's largest {got:.2e} of its kernel's "
              f"gradient, JAX's {floor:.2e}")
        assert got <= FLOOR_FACTOR * floor, (got, floor)
    worst = (0.0, "")
    for k, w in want.items():
        norm = np.linalg.norm(w)
        if noise_bias(k):
            continue
        floor = max(np.linalg.norm(o[k] - w) for o in others)
        err = np.linalg.norm(grads[k] - w)
        assert np.isfinite(grads[k]).all(), k
        assert err <= FLOOR_FACTOR * floor, (k, err / norm, floor / norm)
        worst = max(worst, (err / floor, k))
    print(f"gradients: the worst leaf {worst[1]} at {worst[0]:.2f} of its "
          f"floor")

    def total(a, b):
        return np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in b))

    want = _flat(jstate.params)
    floor = max(total(_flat(s.params), want) for s, _ in nudges)
    err = total(params, want)
    print(f"updated parameters: {err:.4f}, {err / floor:.2f} of the floor")
    assert err <= FLOOR_FACTOR * floor, (err, floor)
    for k, w in want.items():
        # AMSGrad's first step moves a parameter by about lr either way
        np.testing.assert_array_less(np.abs(params[k] - w), 2 * LR + 1e-6, k)

    want = _flat(jstate.batch_stats)
    others = [_flat(s.batch_stats) for s, _ in nudges]
    before = _flat(stats_before)
    assert sorted(stats) == sorted(want)
    worst = (0.0, "")
    for k, w in want.items():
        assert stats[k].dtype == np.float32, k
        # the step a statistic takes is momentum times a batch moment of
        # bf16 activations: one bf16 ulp of it, or JAX's floor if larger
        floor = max([ULP * np.linalg.norm(w - before[k])]
                    + [np.linalg.norm(o[k] - w) for o in others])
        err = np.linalg.norm(stats[k] - w)
        assert err <= FLOOR_FACTOR * floor, (k, err, floor)
        worst = max(worst, (err / floor, k))
    print(f"statistics: the worst leaf {worst[1]} at {worst[0]:.2f} of its "
          f"floor")


@pytest.fixture(scope="module")
def lowcnn_gru_step():
    rng = np.random.default_rng(0)
    left = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    right = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    gt = (40 + 10 * rng.standard_normal((2, 64, 256, 1))).astype(np.float32)
    batch = {"img_left": left, "img_right": right, "gt_disp": gt}
    jmodel = JaxLowCNN(refinement="gru", dtype=jnp.bfloat16)
    shapes = jax.eval_shape(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, iters=1,
                                 train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)
    runs = jax_bf16_steps(jmodel, variables, batch, LR)
    model = LowCNN(dtype=BF)
    model.load_state_dict(lowcnn_state_dict_from_jax(variables))
    state, metrics = port_bf16_step(model, batch, LR)
    return variables, runs, state, metrics


def test_lowcnn_gru_bf16_train_step_matches_jax(lowcnn_gru_step):
    variables, runs, state, metrics = lowcnn_gru_step
    assert state.step == 1 and state.opt_state.count == 1
    tree = _port_tree(state.model)
    grads = _flat(_port_tree(state.model, grads=True)["params"])
    check_within_floor(runs, metrics, grads, _flat(tree["params"]),
                       _flat(tree["batch_stats"]), variables["batch_stats"],
                       _BN_FED_BIAS.search)


def test_lowcnn_gru_bf16_moments_stay_float32(lowcnn_gru_step):
    _, _, state, _ = lowcnn_gru_step
    for moments in (state.opt_state.mu, state.opt_state.nu,
                    state.opt_state.nu_max):
        assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
                   for v in moments.values())


def test_xla_cpu_accumulates_bf16_reductions_in_bf16():
    """Why the JAX reference runs under ``float32_accumulated_transposes``:
    the gradient of a bf16 bias broadcast over 1024 pixels, as XLA on the
    CPU sums it, is off the float32 sum by many bf16 ulps; under it, it is
    the float32 sum rounded once, what the port computes."""
    rng = np.random.default_rng(0)
    g = jnp.asarray(rng.standard_normal((2, 16, 32, 8)) + 0.3, jnp.bfloat16)

    def vjp_bias(cot):
        _, vjp = jax.vjp(lambda b: jnp.zeros(cot.shape, jnp.bfloat16)
                         + b.astype(jnp.bfloat16), jnp.zeros(8, jnp.float32))
        return vjp(cot)[0]

    once = np.asarray(jnp.asarray(np.asarray(g, np.float64).sum((0, 1, 2)),
                                  jnp.float32).astype(jnp.bfloat16),
                      np.float32)
    port = torch.from_numpy(np.asarray(g, np.float32)).to(BF).sum(
        (0, 1, 2)).float().numpy()
    assert np.array_equal(port, once)
    ulp = ULP * 2.0 ** np.floor(np.log2(np.abs(once)))
    assert (np.abs(np.asarray(vjp_bias(g)) - once) > ulp).any()
    with float32_accumulated_transposes():
        assert np.array_equal(np.asarray(jax.jit(vjp_bias)(g)), once)


# --- every registry name, port only ------------------------------------------

# each name's trainer loss (train/trainer.py) and batch size 2 at 32x64
_LOSS = {"LowCNN": "single", "LowCNN_simple": "single", "LowCNN_ada": "equal",
         "LowCNN_dynamic": "equal",
         "LowCNN_dynamic_supervised": "range_supervised"}


def _small_batch(seed, h=32, w=64):
    rng = np.random.default_rng(seed)
    return {"img_left": torch.from_numpy(
                rng.standard_normal((2, h, w, 3), dtype=np.float32)),
            "img_right": torch.from_numpy(
                rng.standard_normal((2, h, w, 3), dtype=np.float32)),
            "gt_disp": torch.from_numpy(
                rng.uniform(1, 40, (2, h, w, 1)).astype(np.float32))}


@pytest.mark.parametrize("name", available_models())
def test_every_registry_name_takes_a_bf16_step(name):
    model = get_model(name, device="cpu", dtype=BF)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tx = train.Amsgrad(LR)
    state = train.TrainState.create(model, tx)
    h, w = (64, 128) if name == "RAFT_Stereo" else (32, 64)
    step = train.make_train_step(tx, _LOSS.get(name, "sequence"), iters=2)
    state, m = step(state, _small_batch(1, h, w))
    assert np.isfinite(float(m["loss"])) and m["loss"].dtype == torch.float32
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        assert torch.isfinite(p.grad).all(), k
    after = model.state_dict()
    assert all(v.dtype == before[k].dtype for k, v in after.items())
    moved = [k for k in before if k.endswith(".weight")
             and not torch.equal(after[k], before[k])]
    assert moved, "the step moved no weight"
    # a second step runs from the updated float32 state
    state, m = step(state, _small_batch(2, h, w))
    assert np.isfinite(float(m["loss"]))


def test_bf16_remat_matches_plain_step_and_freeze_bn_keeps_statistics():
    """``remat`` recomputes the bf16 forward in the backward: the same
    gradients and statistics bit for bit, the statistics moved once;
    ``freeze_bn`` leaves them as they were and still trains."""
    batch = _small_batch(3)
    out = []
    for kw in ({}, {"remat": True}, {"freeze_bn": True}):
        model = get_model("LowCNN_gru", device="cpu", dtype=BF)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        tx = train.Amsgrad(LR)
        state, m = train.make_train_step(tx, "sequence", iters=2, **kw)(
            train.TrainState.create(model, tx), batch)
        out.append((before, model.state_dict(),
                    {k: p.grad.clone() for k, p in model.named_parameters()},
                    float(m["loss"])))
    (_, plain, gp, lp), (_, remat, gr, lr_), (before, frozen, gf, _) = out
    assert lp == lr_
    for k in gp:
        assert torch.equal(gp[k], gr[k]), k
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k
    assert int(remat["conv2.bn1.num_batches_tracked"]) == 1
    for k, v in before.items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            assert torch.equal(frozen[k], v), k
    assert not torch.equal(frozen["conv1.0.weight"], before["conv1.0.weight"])
    assert all(torch.isfinite(g).all() for g in gf.values())
