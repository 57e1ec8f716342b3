"""Worker of the port's data-parallel tests: one rank of a gloo group on the
CPU, single-threaded.

    python tests/_torch_parallel_worker.py RANK WORLD PORT DIR TASK[,TASK...]

Each task runs the port's parallel path on this rank's rows of a global
input made from a seed (the makers below, which the tests call for their
one-process references) and writes what the test compares to
``DIR/<task>_rank<RANK>.pt``. Every rank runs the same tasks in the same
order: their collectives pair up. Imports nothing of JAX.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import torch

ITERS = 2
LR = 1e-3
# the FSDP tasks' leaves under min_elems (JAX keeps them whole) are sharded
# on their first axis too (parallel/fsdp.py)
MIN_ELEMS = 1024


def launch(tasks: list, out_dir: str, world: int = 2) -> tuple:
    """Start ``tasks`` in ``world`` worker processes, one gloo group (of
    one rank where ``world`` is 1: one process on the whole batch); wait
    with ``collect``."""
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), out_dir, ",".join(tasks)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    return procs, tasks, out_dir


def collect(launched: tuple, timeout: float = 300) -> dict:
    """``{(task, rank): output}`` of a ``launch``; raises with a rank's
    stderr if one fails."""
    procs, tasks, out_dir = launched
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errors.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return {(t, r): torch.load(os.path.join(out_dir, f"{t}_rank{r}.pt"),
                               weights_only=False)
            for t in tasks for r in range(len(procs))}


def run_ranks(tasks: list, out_dir: str, world: int = 2) -> dict:
    return collect(launch(tasks, out_dir, world))


def bn_inputs():
    """Two train-mode calls' inputs and cotangents (NHWC, B=4) and the
    norm's parameters and starting statistics (tests/test_torch_train.py's
    BatchNorm case)."""
    rng = np.random.default_rng(5)
    xs = [(3 + 2 * rng.standard_normal((4, 5, 7, 6))).astype(np.float32)
          for _ in range(2)]
    gs = [rng.standard_normal((4, 5, 7, 6)).astype(np.float32)
          for _ in range(2)]
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(6)).astype(np.float32),
              "mean": (0.1 * rng.standard_normal(6)).astype(np.float32),
              "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    return xs, gs, params


def loss_inputs():
    """Predictions, ground truth and bounds for every loss (B=4), with far
    fewer valid pixels in rows 2-3 (rank 1's of two) than in rows 0-1."""
    rng = np.random.default_rng(7)
    shape = (4, 16, 32, 1)
    gt = rng.uniform(1, 60, shape).astype(np.float32)
    gt[2:] = np.where(rng.random(shape[1:]) < 0.8, 0.0, gt[2:])
    gt[0, 0, :3, 0] = [192.0, 0.0, -1.0]
    preds = [gt + rng.normal(0, s, shape).astype(np.float32)
             for s in (6.0, 2.0, 0.7)]
    low = rng.uniform(0, 8, (4, 2, 4, 1)).astype(np.float32)
    lower = rng.uniform(-1, 3, (4, 2, 4, 1)).astype(np.float32)
    upper = rng.uniform(0, 5, (4, 2, 4, 1)).astype(np.float32)
    return {"gt": gt, "preds": preds, "low": low, "lower": lower,
            "upper": upper}


# loss name -> its call on (L = a losses module, inputs, preds, group
# keyword); preds are the ones the gradient is taken for
LOSSES = {
    "epe": lambda L, d, p, **g: L.epe(p[2], d["gt"], **g),
    "sequence_loss": lambda L, d, p, **g: L.sequence_loss(p, d["gt"], **g),
    "single_scale_loss": lambda L, d, p, **g: L.single_scale_loss(
        p[2], d["gt"], **g),
    "single_scale_loss_low_res": lambda L, d, p, **g: L.single_scale_loss(
        d["low"] + p[0][:, ::8, ::8], d["gt"], **g),
    "multi_equal_loss": lambda L, d, p, **g: L.multi_equal_loss(
        p[1:], d["gt"], **g),
    "searching_range_loss": lambda L, d, p, **g: L.searching_range_loss(
        d["low"], p[0][:, ::8, ::8] / 8.0, d["lower"], d["upper"], **g),
    "total_loss": lambda L, d, p, **g: L.total_loss(
        p[2], d["gt"], d["lower"], d["upper"], d["low"] + p[1][:, ::8, ::8],
        **g),
    "range_and_disparity_loss": lambda L, d, p, **g:
        L.range_and_disparity_loss(p[1:], d["gt"], d["low"] + p[0][:, ::8,
                                                                     ::8],
                                   d["lower"], d["upper"], **g),
}


# the data-parallel step's input: at 32x64 the deepest backbone block sees
# 1x2 pixels an image, and a third of its gradients round to below 1e-5,
# where tests/test_torch_train.py's update check takes the sign as unsettled
DP_HW = (64, 128)


def step_batch(H: int = 32, W: int = 64, B: int = 4, seed: int = 3) -> dict:
    """A train batch; the last half of the rows has fewer valid pixels."""
    rng = np.random.default_rng(seed)
    gt = (40 + 10 * rng.standard_normal((B, H, W, 1))).astype(np.float32)
    gt[B // 2:, :, :W // 3] = 0.0
    return {"img_left": rng.standard_normal((B, H, W, 3)).astype(np.float32),
            "img_right": rng.standard_normal((B, H, W, 3)).astype(np.float32),
            "gt_disp": gt}


def make_state(name: str, mesh=None, fsdp: bool = False):
    """Registry model ``name`` (seed-0 weights) and AMSGrad (lr 1e-3):
    (tx, state), sharded over ``mesh`` with ``fsdp``."""
    from stereoformer_tpu_torch import parallel, train
    from stereoformer_tpu_torch.models import get_model

    tx = train.Amsgrad(LR)
    state = train.TrainState.create(get_model(name, device="cpu"), tx)
    if fsdp:
        state, _ = parallel.shard_state_fsdp(state, mesh, min_elems=MIN_ELEMS)
    return tx, state


def run_steps(tx, state, loss: str, batch: dict, steps: int,
              mesh=None, remat: bool = False) -> list:
    """``steps`` train steps (ITERS iterations) on ``batch``, the global
    batch (this rank's rows of it with ``mesh``); each step's metrics."""
    from stereoformer_tpu_torch import parallel, train

    step = train.make_train_step(tx, loss, iters=ITERS, mesh=mesh,
                                 remat=remat)
    data = (parallel.shard_batch(batch, mesh) if mesh is not None
            else {k: torch.from_numpy(v) for k, v in batch.items()})
    metrics = []
    for _ in range(steps):
        state, m = step(state, data)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def state_tensors(state) -> dict:
    """Every tensor of a train state by (group, name): the state dict, the
    gradients, the three moments."""
    out = {("model", k): v for k, v in state.model.state_dict().items()}
    for k, p in state.model.named_parameters():
        out[("grad", k)] = p.grad
    for m in ("mu", "nu", "nu_max"):
        for k, v in getattr(state.opt_state, m).items():
            out[(m, k)] = v
    return out


def digests(tensors: dict) -> dict:
    """A hash of each tensor's bytes: equal digests, equal tensors."""
    import hashlib

    return {k: hashlib.sha1(v.detach().cpu().contiguous().numpy().tobytes()
                            ).hexdigest() for k, v in tensors.items()}


def _sharded_vs_whole(sharded: dict, whole: dict) -> list:
    """The keys where this rank's shard of a sharded state's tensor is not
    bit-equal to the same piece of the unsharded state's."""
    from stereoformer_tpu_torch.parallel.fsdp import _is_dtensor, _shard_of

    bad = []
    for k, v in sharded.items():
        w = whole[k]
        if _is_dtensor(v):
            v, w = v.to_local(), _shard_of(w, v)
        if not torch.equal(v, w):
            bad.append(k)
    return bad


def _fsdp_task(mesh, name: str, out_dir: str) -> dict:
    """Two steps of ``name`` sharded and unsharded under one group, B=2:
    which tensors differ, the metrics, and what each rank holds. For
    LowCNN_gru, the sharded state's checkpoint (written by rank 0) and the
    unsharded state's digests."""
    from stereoformer_tpu_torch import train
    from stereoformer_tpu_torch.parallel import fsdp_shardings
    from stereoformer_tpu_torch.parallel.fsdp import local_tensor

    batch = step_batch(B=2)
    tx, whole = make_state(name, mesh)
    m_whole = run_steps(tx, whole, "sequence", batch, 2, mesh)
    tx_s, sharded = make_state(name, mesh, fsdp=True)
    m_sharded = run_steps(tx_s, sharded, "sequence", batch, 2, mesh)
    out = {"metrics_whole": m_whole, "metrics_sharded": m_sharded,
           "differ": _sharded_vs_whole(state_tensors(sharded),
                                       state_tensors(whole))}
    params = dict(sharded.model.named_parameters())
    replicated = {k for k, d in fsdp_shardings(whole.model, mesh,
                                               min_elems=MIN_ELEMS).items()
                  if d is None}
    out["numel"] = {k: p.numel() for k, p in params.items()}
    out["local_numel"] = {k: local_tensor(p).numel()
                          for k, p in params.items()}
    out["local_moment_numel"] = {
        k: sum(local_tensor(getattr(sharded.opt_state, m)[k]).numel()
               for m in ("mu", "nu", "nu_max")) for k in params}
    out["replicated"] = sorted(replicated)
    if name == "LowCNN_gru":
        train.write_checkpoint(os.path.join(out_dir, "sharded.ckpt"),
                               sharded, {})
        out["whole_digests"] = digests(state_tensors(whole))
        out["whole_step"] = whole.step
    return out


def _resume_task(mesh, out_dir: str) -> dict:
    """The one-process checkpoint the test wrote (``one.ckpt``, LowCNN_gru)
    restored into sharded and unsharded state: which shards differ from
    the file's tensors; one more step of each, which tensors differ."""
    from stereoformer_tpu_torch import train
    from stereoformer_tpu_torch.parallel.fsdp import _is_dtensor, _shard_of

    path = os.path.join(out_dir, "one.ckpt")
    ck = torch.load(path, map_location="cpu", weights_only=True)
    states = {}
    for kind in ("whole", "sharded"):
        tx, st = make_state("LowCNN_gru", mesh, fsdp=kind == "sharded")
        states[kind] = (tx, train.restore_checkpoint(path, st))
    st = states["sharded"][1]
    loaded = {("model", k): v for k, v in st.model.state_dict().items()}
    for m in ("mu", "nu", "nu_max"):
        loaded.update({(m, k): v for k, v in
                       getattr(st.opt_state, m).items()})
    off = []
    for (g, k), v in loaded.items():
        want = ck["model"][k] if g == "model" else ck["opt_state"][g][k]
        if _is_dtensor(v):
            v, want = v.to_local(), _shard_of(want, v)
        if not torch.equal(v, want):
            off.append((g, k))
    out = {"loaded_off": off, "count": st.opt_state.count, "step": st.step}
    for kind, (tx, s) in states.items():
        out[f"metrics_{kind}"] = run_steps(tx, s, "sequence", step_batch(B=2),
                                           1, mesh)
    out["differ"] = _sharded_vs_whole(state_tensors(states["sharded"][1]),
                                      state_tensors(states["whole"][1]))
    return out


def _remat_task(mesh) -> dict:
    """Two LowCNN_gru steps (B=2, a row a rank) with the forward recomputed
    in the backward (``remat``) and without: the recompute all-reduces the
    BatchNorm moments again and leaves the statistics alone."""
    runs = {}
    for remat in (False, True):
        tx, state = make_state("LowCNN_gru", mesh)
        runs[remat] = (run_steps(tx, state, "sequence", step_batch(B=2), 2,
                                 mesh, remat=remat), state)
    (m0, s0), (m1, s1) = runs[False], runs[True]
    return {"metrics": m0, "metrics_remat": m1,
            "differ": _sharded_vs_whole(state_tensors(s1),
                                        state_tensors(s0))}


def _dp_task(mesh, name: str, loss: str, rank: int) -> dict:
    """One data-parallel step of ``name`` with ``loss`` on B=4 at DP_HW;
    rank 0's output has the gradients and the state dict."""
    tx, state = make_state(name, mesh)
    out = {"metrics": run_steps(tx, state, loss, step_batch(*DP_HW), 1,
                                mesh)}
    if rank == 0:
        out["grads"] = {k: p.grad for k, p in
                        state.model.named_parameters()}
        out["model"] = state.model.state_dict()
    return out


def trainer_kw() -> dict:
    """The trainer tasks' run: LowCNN_gru on dummy:4 at 32x64, B=2, two
    steps (one epoch) and a validation of two batches of 2."""
    return dict(lr=LR, dataset="dummy:4", batch_size=2, test_batch=2,
                crop_size=(32, 64), train_iters=ITERS, eval_iters=ITERS,
                num_workers=0, seed=1024)


def run_trainer(mesh=None) -> dict:
    """One epoch and a validation of the trainer tasks' run."""
    from stereoformer_tpu_torch import train

    t = train.DisparityTrainer(**trainer_kw(), device="cpu", mesh=mesh)
    t.initialize()
    loss, epe, iters = t.train_one_epoch(0, 0, 0)
    val = t.validate()
    return {"loss": loss, "epe": epe, "iterations": iters, "val_epe": val,
            "step": t.state.step, "model": t.state.model.state_dict(),
            "nu": t.state.opt_state.nu}


def _bn_task(mesh, rank):
    from stereoformer_tpu_torch.nn import BatchNorm2d
    from stereoformer_tpu_torch.nn.norm import synced_statistics

    xs, gs, p = bn_inputs()
    bn = BatchNorm2d(6)
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(p["mean"]),
                        "running_var": torch.from_numpy(p["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    bn.train()
    rows = slice(2 * rank, 2 * rank + 2)
    out = {"y": [], "dx": [], "dscale": [], "dbias": []}
    for x, g in zip(xs, gs):
        xt = torch.from_numpy(x[rows]).permute(0, 3, 1, 2).requires_grad_()
        bn.weight.grad = bn.bias.grad = None
        with synced_statistics(bn, mesh.get_group()):
            y = bn(xt)
            y.backward(torch.from_numpy(g[rows]).permute(0, 3, 1, 2))
        # the parameters' gradients are the ranks' summed
        for t in (bn.weight.grad, bn.bias.grad):
            torch.distributed.all_reduce(t)
        out["y"].append(y.detach().permute(0, 2, 3, 1).clone())
        out["dx"].append(xt.grad.permute(0, 2, 3, 1).clone())
        out["dscale"].append(bn.weight.grad.clone())
        out["dbias"].append(bn.bias.grad.clone())
    out["mean"], out["var"] = bn.running_mean.clone(), bn.running_var.clone()
    return out


def _losses_task(mesh, rank):
    from stereoformer_tpu_torch import losses

    d = loss_inputs()
    rows = slice(2 * rank, 2 * rank + 2)
    local = {k: torch.from_numpy(v[rows]) for k, v in d.items()
             if k != "preds"}
    out = {}
    for name, call in LOSSES.items():
        preds = [torch.from_numpy(p[rows]).requires_grad_()
                 for p in d["preds"]]
        share = call(losses, local, preds, group=mesh.get_group())
        total = share.detach().clone()
        if name != "epe":       # a metric: global on every rank already
            share.backward()
            torch.distributed.all_reduce(total)
        out[name] = {"share": float(share), "total": float(total),
                     "grads": [p.grad.clone() if p.grad is not None else None
                               for p in preds]}
    return out


def main() -> None:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    out_dir, tasks = sys.argv[4], sys.argv[5].split(",")
    torch.set_num_threads(1)
    from stereoformer_tpu_torch import parallel

    assert parallel.initialize_multihost(f"localhost:{port}", world, rank,
                                         device="cpu")
    mesh = parallel.make_mesh()
    for task in tasks:
        if task == "bn":
            out = _bn_task(mesh, rank)
        elif task == "losses":
            out = _losses_task(mesh, rank)
        elif task.startswith("dp_"):
            # dp_<model>_<loss>
            name, loss = task[3:].rsplit("_", 1)
            out = _dp_task(mesh, name, loss, rank)
        elif task.startswith("fsdp_"):
            out = _fsdp_task(mesh, task[5:], out_dir)
        elif task == "resume_sharded":
            out = _resume_task(mesh, out_dir)
        elif task == "remat":
            out = _remat_task(mesh)
        elif task == "trainer":
            out = run_trainer(mesh)
            del out["nu"]
            if rank:
                del out["model"]
        elif task == "jax_rows":
            out = _jax_rows_task(mesh, out_dir, rank)
        else:
            raise ValueError(f"unknown task {task!r}")
        torch.save(out, os.path.join(out_dir, f"{task}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _jax_rows_task(mesh, out_dir, rank):
    """tests/test_torch_train.py's step: the model and batch it wrote, one
    row a rank; rank 0's output has the state dict and the gradients."""
    from stereoformer_tpu_torch import parallel, train
    from stereoformer_tpu_torch.models import LowCNN

    given = torch.load(os.path.join(out_dir, "jax_rows.pt"),
                       weights_only=False)
    model = LowCNN()
    model.load_state_dict(given["state_dict"])
    tx = train.Amsgrad(LR)
    state = train.TrainState.create(model, tx)
    step = train.make_train_step(tx, "sequence", iters=ITERS, mesh=mesh)
    state, m = step(state, parallel.shard_batch(given["batch"], mesh))
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "step": state.step, "count": state.opt_state.count}
    if rank == 0:
        out["state_dict"] = model.state_dict()
        out["grads"] = {k: p.grad for k, p in model.named_parameters()}
    return out


if __name__ == "__main__":
    main()
