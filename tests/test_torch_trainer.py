"""The port's trainer, checkpoints and from-scratch init against the JAX
package's, on the CPU, at 32x64, B=2, two GRU iterations.

- The JAX ``DisparityTrainer`` (no mesh) initialises; its state goes through
  ``weights.lowcnn_state_dict_from_jax`` and ``amsgrad_state_from_jax`` into
  a port checkpoint, from which the port's ``DisparityTrainer(pretrain=...,
  device="cpu")`` starts; both train one epoch of ``dummy:8`` and validate.
  The per-step losses, each parameter's change over the epoch and the
  EPE must agree.
- A run stopped after 2 epochs and resumed (the CLI's ``--resume``) to 3
  ends bit-equal to an uninterrupted 3-epoch run, and its loss falls.
- ``remat`` (and RAFT's ``remat_update``) leave the gradients and the
  BatchNorm statistics as the plain step leaves them.
- ``weights.init_state_dict`` draws the JAX models' distributions: moments
  per tensor, and orthogonal GRU gates.
- The offset masks, the checkpoint files and the ``pretrain`` fallbacks.
"""

import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu.models.low_cnn import LowCNN as JaxLowCNN  # noqa: E402
from stereoformer_tpu.models.raft_stereo import (  # noqa: E402
    RAFTStereo as JaxRAFT,
)
from stereoformer_tpu.train.torch_import import (  # noqa: E402
    convert_lowcnn_state_dict,
)
from stereoformer_tpu.train.trainer import (  # noqa: E402
    DisparityTrainer as JaxTrainer,
)
from stereoformer_tpu_torch import train  # noqa: E402
from stereoformer_tpu_torch.models import LowCNN, get_model  # noqa: E402
from stereoformer_tpu_torch.models.raft_stereo import RAFTStereo  # noqa: E402
from stereoformer_tpu_torch.train import checkpoint  # noqa: E402
from stereoformer_tpu_torch.weights import (  # noqa: E402
    amsgrad_state_from_jax,
    init_state_dict,
    _find_amsgrad,
    lowcnn_state_dict_from_jax,
    raft_state_dict_from_jax,
)

LR = 1e-3
H, W, B, ITERS = 32, 64, 2, 2
TRAINER_KW = dict(lr=LR, dataset="dummy:8", batch_size=B, test_batch=B,
                  crop_size=(H, W), train_iters=ITERS, eval_iters=ITERS,
                  num_workers=0, seed=1024)
# float32 on both sides, summed in different orders: the first loss (one
# forward from equal weights) to 1e-5 relative (measured 2e-7)
FIRST_LOSS_RTOL = 1e-5
# later losses drift: ~20 backbone ReLUs pass or block their gradient
# differently at float32 kinks (~1% of a backbone gradient,
# tests/test_torch_train.py), and the convs that feed a train-mode
# BatchNorm have a bias gradient of 0 in exact arithmetic, float32 noise of
# either sign on each side, which AMSGrad turns into steps of ~lr. Measured
# up to 4e-4 relative over the epoch's four steps.
LOSS_RTOL = 2e-3
# A parameter is held by its change over the epoch (final - init), norm-wise
# relative per tensor against the JAX change: a trainer that never updates
# reads 1, one that steps against the gradient reads 2. Measured up to
# 7.7e-2 (agg2's BatchNorm bias), most tensors 2e-2 to 6e-2.
DELTA_RTOL = 0.15
# Left out: the tensors whose JAX gradient is 0 up to rounding, the biases
# of the 20 convs that feed a train-mode BatchNorm (the mean subtraction
# cancels them). Their gradient is float32 noise of either sign on each
# side, which AMSGrad still turns into steps of ~lr, so their changes do
# not agree (measured 1.0 to 1.6). The rule reads the RMS gradient of a
# tensor over the epoch from the JAX second moment (nu, bias-corrected)
# against that of all parameters: the BatchNorm-fed biases read 3.7e-8 to
# 3.4e-5, every other tensor 1.9e-2 or more.
NOISE_GRAD = 1e-3
# the running statistics follow the drifting weights: norm-wise relative
# error per tensor (measured up to 1.45e-2)
STATS_RTOL = 3e-2
# the validation EPE (~16 px) of the two trained models (measured 5.4e-3)
EPE_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """A LowCNN_gru checkpoint is a 290 MB file: remove this test's files
    when it ends, not when pytest next prunes its old directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _recording(trainer, losses):
    """Wrap ``trainer.train_step`` to record each step's loss."""
    step = trainer.train_step

    def recorded(state, batch):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        return state, m

    trainer.train_step = recorded


@pytest.fixture(scope="module")
def jax_epoch():
    """The JAX trainer: its initial state (numpy), the losses of one epoch
    of dummy:8, its final variables and its validation EPE."""
    jt = JaxTrainer(**TRAINER_KW)
    jt.initialize()
    init = _np({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
    opt_state = _np(jt.state.opt_state)
    losses = []
    _recording(jt, losses)
    jt.train_one_epoch(0, 0, 0)
    final = _np({"params": jt.state.params,
                 "batch_stats": jt.state.batch_stats})
    nu = _find_amsgrad(_np(jt.state.opt_state)).nu
    return {"init": init, "opt_state": opt_state, "losses": losses,
            "final": final, "nu": nu, "epe": jt.validate(),
            "step": int(jt.state.step)}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_trainer_follows_jax_trainer(jax_epoch, tmp_path):
    model = LowCNN()
    model.load_state_dict(lowcnn_state_dict_from_jax(jax_epoch["init"]))
    state = train.TrainState(
        step=0, model=model,
        opt_state=amsgrad_state_from_jax(jax_epoch["opt_state"], model))
    path = checkpoint.save_checkpoint(str(tmp_path), state, "LowCNN_gru", 0,
                                      0, 0.0, False)

    pt = train.DisparityTrainer(**TRAINER_KW, pretrain=path, device="cpu")
    pt.initialize()
    assert pt.is_pretrain
    losses = []
    _recording(pt, losses)
    loss, epe, iterations = pt.train_one_epoch(0, 0, 0)
    assert iterations == 4 and pt.state.step == jax_epoch["step"] == 4
    assert pt.state.opt_state.count == 4
    assert [h["steps"] for h in pt.history] == [4]
    want = jax_epoch["losses"]
    assert len(losses) == len(want) == 4
    np.testing.assert_allclose(losses[0], want[0], rtol=FIRST_LOSS_RTOL)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, np.mean(want), rtol=LOSS_RTOL)

    got = _flat(convert_lowcnn_state_dict(pt.state.model.state_dict(),
                                          refinement="gru", strict=True))
    final = _flat(jax_epoch["final"])
    init = _flat(jax_epoch["init"])
    assert sorted(got) == sorted(final)
    # the RMS gradient of each tensor over the epoch, from the JAX moments
    nu = _flat({"params": jax_epoch["nu"]})
    nu = {k: v / (1 - 0.999 ** jax_epoch["step"]) for k, v in nu.items()}
    rms_all = np.sqrt(sum(v.sum() for v in nu.values())
                      / sum(v.size for v in nu.values()))
    noise = {k for k, v in nu.items()
             if np.sqrt(v.mean()) < NOISE_GRAD * rms_all}
    assert len(noise) == 20 and all(k.endswith("['bias']") for k in noise)
    held = 0
    for k, w in final.items():
        if k in noise:
            continue
        if k.startswith("['params']"):
            want = w - init[k]
            err = np.linalg.norm(got[k] - init[k] - want) / np.linalg.norm(
                want)
            assert err <= DELTA_RTOL, (k, err)
            held += 1
        else:
            err = np.linalg.norm(got[k] - w) / np.linalg.norm(w)
            assert err <= STATS_RTOL, (k, err)
    assert held == len(nu) - len(noise) > 80
    np.testing.assert_allclose(pt.validate(), jax_epoch["epe"], rtol=EPE_RTOL)


# --- stop and resume ---------------------------------------------------------

RUN_KW = dict(TRAINER_KW, dataset="dummy:4", num_workers=2)


def _train(outf, epochs, pretrain=None, start=0):
    """The CLI's loop: train, validate and save every epoch from
    ``start``; returns the trainer and the epochs' mean losses."""
    trainer = train.DisparityTrainer(**RUN_KW, pretrain=pretrain,
                                     device="cpu")
    trainer.initialize()
    losses = []
    for epoch in range(start, epochs):
        losses.append(trainer.train_one_epoch(epoch, 0, 0)[0])
        train.save_checkpoint(outf, trainer.state, "LowCNN_gru", 0, epoch,
                              trainer.validate(), False)
    return trainer, losses


@pytest.fixture(scope="module")
def whole_run(tmp_path_factory):
    """An uninterrupted run of 3 epochs of dummy:4 (2 steps each)."""
    out = tmp_path_factory.mktemp("whole")
    yield _train(str(out), 3)
    shutil.rmtree(out, ignore_errors=True)


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for m in ("mu", "nu", "nu_max"):
        for k, v in getattr(a.opt_state, m).items():
            assert torch.equal(v, getattr(b.opt_state, m)[k]), (m, k)


def test_stopped_and_resumed_run_equals_uninterrupted(whole_run, tmp_path):
    """Parameters, BatchNorm buffers, AMSGrad moments and count, bit for
    bit; the schedule goes on from the restored count."""
    _train(str(tmp_path), 2)
    latest = train.latest_checkpoint(str(tmp_path), "LowCNN_gru")
    meta = train.checkpoint_meta(latest)
    assert (meta["round"], meta["epoch"], meta["step"]) == (0, 1, 4)
    resumed, _ = _train(str(tmp_path), 3, pretrain=latest,
                        start=meta["epoch"] + 1)
    assert resumed.is_pretrain
    whole = whole_run[0]
    assert whole.state.step == resumed.state.step == 6
    _assert_states_equal(resumed.state, whole.state)
    # the BatchNorm statistics moved once per step
    assert int(whole.state.model.state_dict()[
        "conv2.bn1.num_batches_tracked"]) == 6


def test_trainer_loss_falls(whole_run):
    losses = whole_run[1]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# --- remat -------------------------------------------------------------------

def _seeded_batch(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    return {"img_left": torch.from_numpy(
                rng.standard_normal((B, h, w, 3), dtype=np.float32)),
            "img_right": torch.from_numpy(
                rng.standard_normal((B, h, w, 3), dtype=np.float32)),
            "gt_disp": torch.from_numpy(
                rng.uniform(1, 40, (B, h, w, 1)).astype(np.float32))}


def _step_pair(name, batch, iters, make_model=None, **step_kw):
    """One plain and one remat train step from the same weights: the two
    states, and each step's gradients."""
    out = []
    for remat in (False, True):
        model = (make_model or (lambda: get_model(name, device="cpu")))()
        tx = train.Amsgrad(LR)
        state = train.TrainState.create(model, tx)
        kw = dict(step_kw)
        if name != "RAFT_Stereo":
            kw["remat"] = remat
        elif remat:
            model.remat_update = True
        step = train.make_train_step(tx, "sequence", iters=iters, **kw)
        state, m = step(state, batch)
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        out.append((state, m, grads))
    return out


def test_remat_matches_plain_step_with_batchnorm_statistics():
    (a, ma, ga), (b, mb, gb) = _step_pair("LowCNN_gru", _seeded_batch(0),
                                          ITERS)
    assert float(ma["loss"]) == float(mb["loss"])
    for k in ga:
        torch.testing.assert_close(gb[k], ga[k], rtol=0, atol=0, msg=k)
    # the running statistics moved once (not twice, as a second train-mode
    # forward in the backward would move them), to the plain step's values
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert int(sb["conv2.bn1.num_batches_tracked"]) == 1
    assert all(m.update_statistics for m in b.model.modules()
               if hasattr(m, "update_statistics"))


def test_raft_remat_update_matches_plain_step():
    (a, ma, ga), (b, mb, gb) = _step_pair(
        "RAFT_Stereo", _seeded_batch(1, 64, 128), 2)
    assert b.model.remat_update and not a.model.remat_update
    assert float(ma["loss"]) == float(mb["loss"])
    for k in ga:
        torch.testing.assert_close(gb[k], ga[k], rtol=0, atol=0, msg=k)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# --- the from-scratch init -------------------------------------------------------

def _jax_init(model, h, w):
    left = jnp.zeros((1, h, w, 3), jnp.float32)
    return _np(jax.jit(lambda k: model.init(k, left, left, iters=1,
                                            train=False))(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def lowcnn_inits():
    want = lowcnn_state_dict_from_jax(_jax_init(JaxLowCNN(refinement="gru"),
                                                H, W))
    return init_state_dict(LowCNN(), seed=3), want


@pytest.fixture(scope="module")
def raft_inits():
    want = raft_state_dict_from_jax(_jax_init(JaxRAFT(), 64, 128))
    return init_state_dict(RAFTStereo(), seed=3), want


def _check_moments(got, want):
    """Per tensor: the same keys; zeros and ones where JAX has them; else
    the same standard deviation within five standard errors of a sample
    std (1/sqrt(2n)), a mean within five standard errors of zero, and no
    value beyond the truncation at two standard deviations (of the
    untruncated normal, std / 0.8796)."""
    assert sorted(got) == sorted(want)
    n_drawn = 0
    for k, w in want.items():
        g = got[k].double().numpy()
        w = w.double().numpy()
        if np.all(w == w.flat[0]):          # zeros, ones, counts
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        n = w.size
        sw, sg = w.std(), g.std()
        assert abs(sg / sw - 1) <= 5 / np.sqrt(2 * n) + 1e-3, (k, sg, sw)
        assert abs(g.mean()) <= 5 * sw / np.sqrt(n), k
        if "gru.conv_" not in k:
            assert np.abs(g).max() <= 2 * sw / 0.87962566 * 1.05, k
        n_drawn += 1
    return n_drawn


def test_lowcnn_init_matches_jax_moments(lowcnn_inits):
    assert _check_moments(*lowcnn_inits) > 25


def test_raft_init_matches_jax_moments(raft_inits):
    assert _check_moments(*raft_inits) > 50


@pytest.mark.parametrize("gate", ["conv_z", "conv_b", "conv_g"])
def test_lowcnn_gru_gates_orthogonal(lowcnn_inits, gate):
    """Each gate's [C_out, 9 C_in] weight has orthonormal rows, as each
    half of the JAX ``conv_zb`` (and ``conv_g``) has; a plain normal draw
    would not."""
    for sd in lowcnn_inits:
        w = sd[f"local_cost_volume.gru.{gate}.weight"].double()
        w = w.reshape(w.shape[0], -1)
        torch.testing.assert_close(w @ w.T, torch.eye(w.shape[0],
                                                      dtype=torch.float64),
                                   rtol=0, atol=1e-5)
        assert not sd[f"local_cost_volume.gru.{gate}.bias"].any()


def test_trainer_starts_from_the_jax_distributions():
    trainer = train.DisparityTrainer(**TRAINER_KW, device="cpu")
    trainer.initialize()
    assert not trainer.is_pretrain
    want = init_state_dict(trainer.net, seed=TRAINER_KW["seed"])
    got = trainer.net.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# --- offset masks -------------------------------------------------------------------

@pytest.mark.parametrize("mask", ["freeze_offsets", "only_offsets"])
def test_offset_masks_leave_masked_parameters(mask):
    model = get_model("LowCNN_dynamic", device="cpu")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    tx = getattr(train, mask)(train.Amsgrad(LR))
    state = train.TrainState.create(model, tx)
    step = train.make_train_step(tx, "equal", iters=1)
    state, _ = step(state, _seeded_batch(2, 64, 128))
    offsets = {k for k in before if train.params.is_offset_param(k)}
    assert offsets == {
        "local_cost_volume.unet.deformblock.conv2.conv_offset_mask.weight",
        "local_cost_volume.unet.deformblock.conv2.conv_offset_mask.bias"}
    frozen = offsets if mask == "freeze_offsets" else set(before) - offsets
    moved = 0
    for k, p in model.named_parameters():
        if k in frozen:
            assert torch.equal(p, before[k]), k
            for m in ("mu", "nu", "nu_max"):
                assert not getattr(state.opt_state, m)[k].any(), (m, k)
        elif p.grad.any():
            assert not torch.equal(p, before[k]), k
            moved += 1
    assert moved > 0 and state.opt_state.count == 1


# --- checkpoints and pretrain ---------------------------------------------------

def _fresh_state():
    model = get_model("LowCNN_gru", device="cpu")
    return train.TrainState.create(model, train.Amsgrad(LR))


def test_checkpoint_round_trip_and_names(tmp_path):
    state = _fresh_state()
    with torch.no_grad():
        for v in state.opt_state.mu.values():
            v.add_(0.5)
    state.opt_state.count, state.step = 7, 7
    p1 = train.save_checkpoint(str(tmp_path), state, "LowCNN_gru", 0, 1,
                               2.34567, True)
    p2 = train.save_checkpoint(str(tmp_path), state, "LowCNN_gru", 1, 0,
                               1.5, False)
    assert os.path.basename(p1) == "LowCNN_gru_0_1_2.346"
    assert os.path.isfile(tmp_path / "model_best")
    # a file still under its temporary name is not resumed from
    (tmp_path / ".LowCNN_gru_2_0_1.000.tmp.1").write_bytes(b"half")
    (tmp_path / "LowCNN_gru_2_5_1.000.tmp.9").write_bytes(b"half")
    assert train.latest_checkpoint(str(tmp_path), "LowCNN_gru") == p2
    assert train.latest_checkpoint(str(tmp_path), "RAFT_Stereo") is None
    meta = train.checkpoint_meta(p1)
    assert meta == {"round": 0, "epoch": 1, "arch": "LowCNN_gru",
                    "best_EPE": 2.34567, "step": 7}
    assert train.checkpoint_meta(str(tmp_path / "x_3_4_0.5")) == {
        "round": 3, "epoch": 4, "best_EPE": 0.5}
    restored = train.restore_checkpoint(str(tmp_path / "model_best"),
                                        _fresh_state())
    _assert_states_equal(restored, state)


def test_pretrain_falls_back_to_parameters_only(tmp_path):
    """A file without optimizer state restores the model and the step, the
    moments fresh; a bare state_dict the model only; a file that does not
    match starts fresh, the model untouched."""
    src = _fresh_state()
    with torch.no_grad():
        for p in src.model.parameters():
            p.mul_(0.5)
    sd = src.model.state_dict()
    torch.save({"model": sd, "step": 3}, tmp_path / "no_opt.pth")
    torch.save(sd, tmp_path / "bare.pth")
    bad = {k: v for k, v in sd.items() if "gru" not in k}
    torch.save({"model": bad, "step": 3}, tmp_path / "bad.pth")
    for name, loaded, step in (("no_opt.pth", True, 3), ("bare.pth", True, 0),
                               ("bad.pth", False, 0)):
        trainer = train.DisparityTrainer(
            **TRAINER_KW, pretrain=str(tmp_path / name), device="cpu")
        trainer.initialize()
        assert trainer.is_pretrain == loaded, name
        assert trainer.state.step == step and trainer.state.opt_state.count == 0
        assert not any(v.any() for v in trainer.state.opt_state.mu.values())
        got = trainer.state.model.state_dict()
        fresh = init_state_dict(trainer.net, seed=TRAINER_KW["seed"])
        for k in sd:
            assert torch.equal(got[k], sd[k] if loaded else fresh[k]), (name,
                                                                          k)


def test_trainer_refuses_what_is_not_ported():
    for kw in ({"mesh": object()}, {"fsdp": True}, {"dtype": "bf16"},
               {"gru_loop": "scan"}):
        with pytest.raises(NotImplementedError):
            train.DisparityTrainer(**TRAINER_KW, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.DisparityTrainer(**TRAINER_KW)
