"""The port's data parallelism and sharded state on the CPU.

Two gloo ranks are started once for the file (``_torch_parallel_worker``,
one thread each) and run every two-rank check in one go; each test
reads its task's results and holds them against JAX on the whole batch or
against the port in one process:
- ``parallel``'s batch helpers and ``fsdp_spec`` against JAX's;
- the global ``BatchNorm2d`` against ``flax.linen.BatchNorm`` on the whole
  batch: values, gradients, running statistics;
- every loss with global denominators, the ranks holding unequal numbers
  of valid pixels, against JAX's losses on the whole batch;
- one data-parallel step of ``LowCNN_gru`` ("sequence") and of ``LowCNN``
  ("single", a masked mean) against one process on the whole batch, and
  two ``LowCNN_gru`` steps under ``remat`` against two without;
- two FSDP steps of ``LowCNN_gru`` and ``RAFT_Stereo`` against the same
  steps unsharded in the same group, and what each rank holds;
- a checkpoint of sharded state loading in one process, and the reverse;
- ``DisparityTrainer(mesh=)`` for an epoch of two steps against one
  process.
"""

import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

torch.set_num_threads(1)

import _torch_parallel_worker as worker  # noqa: E402
from test_torch_train import (  # noqa: E402
    _check_grads,
    _check_updated_params,
    _flat,
)
from test_torch_trainer import (  # noqa: E402
    DELTA_RTOL,
    EPE_RTOL,
    LOSS_RTOL,
    NOISE_GRAD,
    STATS_RTOL,
)

from stereoformer_tpu import losses as jlosses  # noqa: E402
from stereoformer_tpu import parallel as jparallel  # noqa: E402
from stereoformer_tpu.parallel import distributed as jdistributed  # noqa: E402
from stereoformer_tpu.train.torch_import import (  # noqa: E402
    convert_lowcnn_state_dict,
    convert_raft_state_dict,
)
from stereoformer_tpu_torch import parallel, train  # noqa: E402
from stereoformer_tpu_torch.models import get_model  # noqa: E402
from stereoformer_tpu_torch.parallel import distributed  # noqa: E402
from stereoformer_tpu_torch.weights import jax_layout  # noqa: E402

DP_TASKS = ["dp_LowCNN_gru_sequence", "dp_LowCNN_single"]
TASKS = ["bn", "losses", *DP_TASKS, "remat", "fsdp_LowCNN_gru",
         "fsdp_RAFT_Stereo", "resume_sharded", "trainer"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every task's output, ``{(task, rank): ...}`` (the data-parallel
    steps' references in one process as ``(task, "one")``), and the
    directory of the checkpoints. The ranks resume from ``one.ckpt``:
    LowCNN_gru after one step in this process."""
    d = tmp_path_factory.mktemp("ranks")
    tx, state = worker.make_state("LowCNN_gru")
    worker.run_steps(tx, state, "sequence", worker.step_batch(B=2), 1)
    train.write_checkpoint(str(d / "one.ckpt"), state, {})
    two = worker.launch(TASKS, str(d))
    one = worker.launch(DP_TASKS, str(d / "one"), world=1)
    out = worker.collect(two)
    out.update({(t, "one"): v for (t, _), v in worker.collect(one).items()})
    yield d, out
    shutil.rmtree(d, ignore_errors=True)


# --- the helpers at one process ----------------------------------------------

def test_batch_helpers_match_jax_at_one_process(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_multihost() is False
    assert not torch.distributed.is_initialized()
    for n in (1, 5, 16):
        assert (distributed.host_shard_slice(n)
                == jdistributed.host_shard_slice(n))
        assert parallel.host_local_batch(n) == jparallel.host_local_batch(n)
    batch = {"x": np.arange(6.0).reshape(3, 2), "name": ["a"]}
    got = parallel.pad_batch_to(batch, 8)
    want = jparallel.pad_batch_to(batch, 8)
    np.testing.assert_array_equal(got["x"], want["x"])
    assert got["name"] == want["name"]
    # the trainer's name for it stays
    from stereoformer_tpu_torch.train.trainer import pad_batch_to
    assert pad_batch_to is parallel.pad_batch_to
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        parallel.make_mesh()


def _marked(model, fill) -> dict:
    """The model's state dict with each parameter replaced by
    ``fill(index, parameter)`` (numpy)."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    for i, (k, p) in enumerate(model.named_parameters()):
        sd[k] = fill(i, p)
    return sd


def _to_jax(name, sd):
    if name == "RAFT_Stereo":
        return convert_raft_state_dict(sd)["params"]
    return convert_lowcnn_state_dict(sd, refinement="gru")["params"]


@pytest.mark.parametrize("name", ["LowCNN_gru", "RAFT_Stereo"])
def test_fsdp_spec_matches_jax(name):
    """``fsdp_spec`` against JAX's on every leaf of the model's JAX tree
    (the port's parameters mapped through the JAX package's converter) at
    n = 1, 2, 4; ``weights.jax_layout`` gives each parameter the shape of
    the leaf it lands in; and the axis ``fsdp_shardings`` shards is the
    one JAX shards: a parameter marked along that axis lands in a leaf
    that varies along JAX's sharded axis alone."""
    model = get_model(name, device="cpu")
    params = dict(model.named_parameters())
    # each parameter filled with its own number: where it lands
    ids = _flat(_to_jax(name, _marked(
        model, lambda i, p: np.full(p.shape, i + 1, np.float32))))
    index = list(params)
    leaf_of = {}
    for path, leaf in ids.items():
        for i in np.unique(leaf):
            leaf_of[index[int(i) - 1]] = path
    assert sorted(leaf_of) == sorted(params)
    leaves = {path: leaf.shape for path, leaf in ids.items()}
    for k in params:
        assert jax_layout(model, k)[0] == leaves[leaf_of[k]], k
    for n in (1, 2, 4):
        for path, shape in leaves.items():
            assert parallel.fsdp_spec(shape, n) == tuple(
                jparallel.fsdp_spec(shape, n)), (path, n)
        dims = parallel.fsdp_shardings(model, n)
        # each parameter numbered along the axis the port shards
        marked = _flat(_to_jax(name, _marked(model, lambda i, p: (
            np.zeros(p.shape, np.float32) if dims[index[i]] is None else
            np.broadcast_to(np.arange(p.shape[dims[index[i]]]).reshape(
                [-1 if a == dims[index[i]] else 1 for a in range(p.dim())]),
                p.shape).astype(np.float32)))))
        for k in params:
            spec = tuple(jparallel.fsdp_spec(leaves[leaf_of[k]], n))
            assert (dims[k] is None) == (spec == ()), (k, n)
            if spec:
                leaf = marked[leaf_of[k]]
                axis = spec.index("data")
                moved = np.moveaxis(leaf, axis, 0).reshape(leaf.shape[axis],
                                                           -1)
                assert (moved == moved[:, :1]).all(), (k, n)
                assert moved[1, 0] != moved[0, 0], (k, n)


# --- the global BatchNorm and the losses -------------------------------------

def test_global_batchnorm_in_two_ranks_matches_flax_on_the_batch(ranks):
    """Two train-mode calls, each rank holding 2 of 4 rows: outputs, input
    and parameter gradients, the running statistics (Flax's biased
    variance, momentum 0.9)."""
    _, out = ranks
    xs, gs, p = worker.bn_inputs()
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = {"params": {"scale": p["scale"], "bias": p["bias"]},
                 "batch_stats": {"mean": p["mean"], "var": p["var"]}}
    r0, r1 = out[("bn", 0)], out[("bn", 1)]
    for i, (x, g) in enumerate(zip(xs, gs)):
        def f(params, xx, stats=variables["batch_stats"]):
            return bn.apply({"params": params, "batch_stats": stats}, xx,
                            mutable=["batch_stats"])

        (want, mutated), vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
        dparams, dx = vjp((jnp.asarray(g), jax.tree_util.tree_map(
            jnp.zeros_like, mutated)))
        variables["batch_stats"] = mutated["batch_stats"]
        # float32 over 140 values per channel (test_torch_train.py's)
        np.testing.assert_allclose(
            torch.cat([r0["y"][i], r1["y"][i]]).numpy(), np.asarray(want),
            rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            torch.cat([r0["dx"][i], r1["dx"][i]]).numpy(), np.asarray(dx),
            rtol=0, atol=1e-5)
        for r in (r0, r1):
            np.testing.assert_allclose(r["dscale"][i].numpy(),
                                       np.asarray(dparams["scale"]),
                                       atol=1e-4)
            np.testing.assert_allclose(r["dbias"][i].numpy(),
                                       np.asarray(dparams["bias"]),
                                       atol=1e-4)
    for r in (r0, r1):
        np.testing.assert_allclose(r["mean"].numpy(), np.asarray(
            variables["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["var"].numpy(), np.asarray(
            variables["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(worker.LOSSES))
def test_losses_in_two_ranks_match_jax_on_the_batch(ranks, name):
    """Each rank's share sums to JAX's loss on the whole batch, and the
    ranks' gradients are JAX's, though rank 1 holds far fewer valid pixels
    than rank 0 (the mean of the ranks' own masked means would be
    another number)."""
    _, out = ranks
    d = worker.loss_inputs()
    jd = {k: jnp.asarray(v) for k, v in d.items() if k != "preds"}
    call = worker.LOSSES[name]
    preds = [jnp.asarray(p) for p in d["preds"]]
    want, jgrads = jax.value_and_grad(
        lambda ps: call(jlosses, jd, ps))(preds)
    r0, r1 = out[("losses", 0)][name], out[("losses", 1)][name]
    # float32 sums over ~2000 pixels (test_torch_train.py's loss cases)
    for r in (r0, r1):
        np.testing.assert_allclose(r["total"], float(want), rtol=1e-5)
    if name == "epe":
        return      # a metric: no gradient through the all-reduce
    np.testing.assert_allclose(r0["share"] + r1["share"], float(want),
                               rtol=1e-5)
    assert r0["share"] != pytest.approx(r1["share"], rel=1e-3)
    for i, jg in enumerate(jgrads):
        got = [r0["grads"][i], r1["grads"][i]]
        if got[0] is None:
            assert not np.asarray(jg).any()
            continue
        np.testing.assert_allclose(torch.cat(got).numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-9)


# --- the data-parallel step ---------------------------------------------------

# the GRU's mask head: its first conv feeds a ReLU whose inputs within
# float32 rounding of 0 pass or block the gradient differently on the two
# sides, as the backbone's do (tests/test_torch_train.py); measured 4.6e-4
# norm-wise here, every other leaf after the cost volume 4e-5 or less. Held
# to the ReLU-fed convs' tolerance of tests/test_torch_raft_options_train.py
_RELU_FED = re.compile(r"\['gru_update'\]\['mask_conv1'\]")
KINK_GRAD_RTOL = 5e-3


@pytest.mark.parametrize("name,loss", [("LowCNN_gru", "sequence"),
                                       ("LowCNN", "single")])
def test_dp_step_in_two_ranks_matches_one_process(ranks, name, loss):
    """One step on B=4 at 64x128, two rows a rank, rank 1's rows with a
    third of their pixels invalid, against one process on the whole batch,
    with tests/test_torch_train.py's checks (there against JAX): loss and
    EPE, the gradient norm, every gradient, the updated parameters and the
    BatchNorm statistics. The process runs the step as a group of one, so
    that its BatchNorm takes Flax's variance E[x²] − E[x]² as the ranks do
    (tests/test_torch_train.py holds the two ranks against JAX itself).
    Without a group the port takes the two-pass variance, which moves
    LowCNN_gru's gradients after the cost volume by up to 3.5e-3 here (the
    first aggregation's BatchNorm), past the 1e-4 held below."""
    _, out = ranks
    task = f"dp_{name}_{loss}"
    one = out[(task, "one")]
    (want,) = one["metrics"]
    for r in (0, 1):
        (got,) = out[(task, r)]["metrics"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["epe"], want["epe"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=3e-4)
    start = worker.make_state(name)[1].model
    ref = start.refinement

    def tree(sd, grads=None):
        return convert_lowcnn_state_dict({**sd, **(grads or {})},
                                         refinement=ref)

    dp = out[(task, 0)]
    grads_dp = _flat(tree(dp["model"], dp["grads"])["params"])
    grads_one = _flat(tree(one["model"], one["grads"])["params"])
    kinked = {k for k in grads_one if _RELU_FED.search(k)}
    _check_grads({k: v for k, v in grads_dp.items() if k not in kinked},
                 {k: v for k, v in grads_one.items() if k not in kinked})
    for k in kinked:
        err = np.linalg.norm(grads_dp[k] - grads_one[k]) / np.linalg.norm(
            grads_one[k])
        assert err <= KINK_GRAD_RTOL, (k, err)
    got_tree, want_tree = tree(dp["model"]), tree(one["model"])
    _check_updated_params(_flat(got_tree["params"]),
                          _flat(want_tree["params"]),
                          _flat(tree(start.state_dict())["params"]),
                          grads_dp, grads_one)
    got_stats, want_stats = (_flat(got_tree["batch_stats"]),
                             _flat(want_tree["batch_stats"]))
    assert sorted(got_stats) == sorted(want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(got_stats[k], w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_dp_step_with_remat_is_the_step_without(ranks):
    """Under ``remat`` the recompute runs each BatchNorm's all-reduce again
    while ``frozen_statistics`` holds the buffers: two steps end with the
    same parameters, gradients, statistics and moments, bit for bit, and
    the same metrics."""
    _, out = ranks
    for r in (0, 1):
        got = out[("remat", r)]
        assert got["differ"] == []
        assert got["metrics_remat"] == got["metrics"]


# --- FSDP ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["LowCNN_gru", "RAFT_Stereo"])
def test_fsdp_in_two_ranks_matches_unsharded(ranks, name):
    """Two steps (B=2 at 32x64, a row a rank) under FSDP and unsharded in
    the same group: every parameter, gradient, BatchNorm statistic and
    AMSGrad moment bit-equal on each rank's shard (FSDP2 averages the
    gradients of a backward run on twice the share: exact at n = 2), the
    same losses, and the gradient norm summed from the shards within
    float32 summation noise. Each rank holds at most half of every
    parameter JAX shards, the leaves JAX keeps whole (under ``min_elems``)
    sharded on their first axis."""
    _, out = ranks
    task = f"fsdp_{name}"
    r0, r1 = out[(task, 0)], out[(task, 1)]
    for r in (r0, r1):
        assert r["differ"] == []
        for a, b in zip(r["metrics_sharded"], r["metrics_whole"]):
            assert a["loss"] == b["loss"] and a["epe"] == b["epe"]
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                       rtol=1e-4)
    numel, repl = r0["numel"], set(r0["replicated"])
    assert repl and len(repl) < len(numel)
    for k, n in numel.items():
        assert r0["local_numel"][k] + r1["local_numel"][k] == n, k
        assert r0["local_moment_numel"][k] == 3 * r0["local_numel"][k], k
        if k not in repl:
            assert r0["local_numel"][k] == r1["local_numel"][k] == n // 2, k
    total, small = sum(numel.values()), sum(numel[k] for k in repl)
    for r in (r0, r1):
        assert sum(r["local_numel"].values()) <= total / 2 + small
        assert sum(r["local_moment_numel"].values()) <= 3 * (total / 2
                                                             + small)


def test_sharded_checkpoint_loads_in_one_process(ranks):
    """The checkpoint rank 0 wrote from FSDP state holds whole tensors: it
    restores into a one-process state, bit-equal to the same run
    unsharded."""
    d, out = ranks
    tx, state = worker.make_state("LowCNN_gru")
    state = train.restore_checkpoint(str(d / "sharded.ckpt"), state)
    want = out[("fsdp_LowCNN_gru", 0)]
    assert state.step == want["whole_step"] == 2
    assert state.opt_state.count == 2
    got = worker.digests({k: v for k, v in worker.state_tensors(
        state).items() if k[0] != "grad"})
    assert got == {k: v for k, v in want["whole_digests"].items()
                   if k[0] != "grad"}


def test_one_process_checkpoint_resumes_sharded(ranks):
    """One step's checkpoint written in one process restores into sharded
    state (each rank's shards equal to the file's tensors, count and step
    1), and the next step sharded equals it unsharded."""
    _, out = ranks
    for r in (0, 1):
        got = out[("resume_sharded", r)]
        assert got["loaded_off"] == [] and got["differ"] == []
        assert got["count"] == got["step"] == 1
        assert got["metrics_sharded"][0]["loss"] == got["metrics_whole"][0][
            "loss"]


# --- the trainer --------------------------------------------------------------

def test_trainer_on_a_mesh_matches_one_process(ranks):
    """An epoch of two steps on dummy:4 (B=2, a row a rank) and a
    validation, against one process, with tests/test_torch_trainer.py's
    checks (there against JAX's trainer): the epoch's mean loss and EPE,
    each parameter's change over the epoch (but the BatchNorm-fed biases,
    whose gradient is float32 noise), the running statistics, the
    validation EPE (over padded global batches), the step count."""
    _, out = ranks
    want = worker.run_trainer()
    t = train.DisparityTrainer(**worker.trainer_kw(), device="cpu")
    t._build_net()
    start = t.net.state_dict()
    for r in (0, 1):
        got = out[("trainer", r)]
        assert got["iterations"] == want["iterations"] == 2
        assert got["step"] == want["step"] == 2
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["epe"], want["epe"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["val_epe"], want["val_epe"],
                                   rtol=EPE_RTOL)
    nu = {k: v / (1 - 0.999 ** 2) for k, v in want["nu"].items()}
    rms_all = np.sqrt(sum(float(v.sum()) for v in nu.values())
                      / sum(v.numel() for v in nu.values()))
    noise = {k for k, v in nu.items()
             if float(v.mean()) ** 0.5 < NOISE_GRAD * rms_all}
    assert noise and all(k.endswith(".bias") for k in noise)
    got = out[("trainer", 0)]["model"]
    held = 0
    for k, w in want["model"].items():
        if k in noise or not w.is_floating_point():
            continue
        if k in nu:
            change = (w - start[k]).double()
            err = ((got[k] - start[k]).double() - change).norm() / (
                change.norm())
            assert err <= DELTA_RTOL, (k, float(err))
            held += 1
        else:
            err = (got[k] - w).double().norm() / w.double().norm()
            assert err <= STATS_RTOL, (k, float(err))
    assert held == len(nu) - len(noise)
