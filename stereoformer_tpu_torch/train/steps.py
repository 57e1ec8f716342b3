"""Train, eval and inference steps.

Counterpart of ``stereoformer_tpu/train/steps.py``: forward, loss, backward,
optimizer update, BatchNorm statistics and metrics of one batch. PyTorch runs
eagerly, so a step is a plain function; it updates the state in place, as the
JAX step's donated state is reused. The model is the state's.

Data parallel (``mesh=``, a ``parallel.make_mesh`` mesh, one rank a device):
each rank runs the step on its rows of the global batch. JAX computes the
step on the global batch under ``jit`` and XLA inserts the collectives;
here the step makes the same ones itself, so that the values are the
one-process step's on the whole batch:
- the BatchNorm statistics are the global batch's
  (``nn.norm.synced_statistics``), in the forward and in ``remat``'s
  recompute;
- each rank's loss is its share of the global loss (``losses``: global
  denominators), and the gradients are summed over the ranks;
- ``loss``, ``epe`` and ``grad_norm`` come back global, on every rank.

The gradients are summed by a few flat all-reduces after the backward
(``_all_reduce_grads``), not by ``DistributedDataParallel``: DDP stops on a
parameter the loss does not reach unless told to search the graph for it
every step (the step gives such a parameter a zero gradient, as JAX does:
``LowCNN_gru`` with ``upsample="simple"``), averages where the shares need
a sum, and overwrites the BatchNorm buffers from rank 0 at every forward,
which global statistics keep equal anyway. A model sharded by
``parallel.shard_state_fsdp`` gets its gradients reduce-scattered by FSDP2
instead, which averages them: its backward runs on n times the share.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from .. import losses
from ..metrics import thres_metric
from ..nn.norm import frozen_statistics, synced_statistics
from ..ops import scale_disp
from ..parallel.distributed import global_sum, group_size
from ..parallel.fsdp import local_tensor
from .optim import Amsgrad
from .state import TrainState

LOSS_NAMES = ("sequence", "equal", "single", "range_supervised")


def compute_loss(loss_name: str, out: dict, gt: torch.Tensor,
                 gamma: float = 0.8, weights: Sequence[float] = (0.8, 1.2),
                 group=None):
    """The loss ``loss_name`` of a model's outputs; under a data-parallel
    ``group``, this rank's share of the global batch's (``losses``)."""
    preds = out["disparities"]
    if loss_name == "sequence":
        return losses.sequence_loss(preds, gt, gamma=gamma, group=group)
    if loss_name == "equal":
        return losses.multi_equal_loss(preds, gt, weights=weights,
                                       group=group)
    if loss_name == "single":
        return losses.single_scale_loss(preds[-1], gt, group=group)
    if loss_name == "range_supervised":
        lower, upper = out["bounds"]
        return losses.range_and_disparity_loss(
            preds, gt, out["disp_low"], lower, upper, weights=weights,
            group=group)
    raise ValueError(f"unknown loss {loss_name!r}; one of {LOSS_NAMES}")


def global_norm(tensors, group=None) -> torch.Tensor:
    """The L2 norm of all the tensors together, as ``optax.global_norm``;
    with ``group``, of tensors sharded over its ranks (each rank passes its
    shards)."""
    if group is None:
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(t) for t in tensors]))
    sq = torch.stack([local_tensor(t).square().sum() for t in tensors]).sum()
    return global_sum(sq, group).sqrt()


# the gradients' all-reduce: flat buffers of at most this many bytes
_BUCKET_BYTES = 1 << 25


@torch.no_grad()
def _all_reduce_grads(grads: list, group) -> None:
    """Sum each gradient over ``group``'s ranks, in place, a few flat
    buffers at a time."""
    bucket: list = []
    size = 0
    for g in grads + [None]:
        if g is not None:
            bucket.append(g)
            size += g.numel() * g.element_size()
        if bucket and (g is None or size >= _BUCKET_BYTES):
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            offset = 0
            for b in bucket:
                b.copy_(flat[offset:offset + b.numel()].view(b.shape))
                offset += b.numel()
            bucket, size = [], 0


def _is_sharded(model) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def make_train_step(tx: Amsgrad, loss_name: str = "sequence",
                    iters: int = 12, gamma: float = 0.8,
                    weights: Sequence[float] = (0.8, 1.2),
                    freeze_bn: bool = False, remat: bool = False,
                    mesh=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; batch is
    ``{"img_left", "img_right", "gt_disp"}`` on the model's device, metrics
    ``{"loss", "epe", "grad_norm"}`` (0-d tensors; grad_norm is the L2 norm
    of all gradients). The step leaves this batch's gradients in each
    parameter's ``.grad``: zeros for a parameter the loss does not reach,
    as in JAX, so that it is left as it was.

    The model is the state's, ``LowCNN`` or ``RAFTStereo``; a step runs it
    in train mode, every output supervised by ``loss_name`` (``iters`` of
    them for the GRU models; the initial and refined disparities of the
    other LowCNN refinements but "none", with the bounds too for
    ``loss_name="range_supervised"``, which takes
    ``LowCNN_dynamic_supervised``).

    ``freeze_bn=True`` is the fine-tune knob (RAFT's, in the reference):
    every BatchNorm normalises with its running statistics, which stay as
    they are, while the parameters still get gradients; RAFT's context net
    then takes them as the fused conv's prologue, whose backward passes
    the gradient on to the BatchNorm's scale and shift.

    ``remat=True`` runs the forward under ``torch.utils.checkpoint``
    (non-reentrant), as the JAX step's ``jax.checkpoint``: only its inputs
    are kept, and the backward runs it again. The BatchNorm running
    statistics move once, in the first run (``nn.norm.frozen_statistics``
    holds them through the second), so the step ends with the same
    parameters, statistics and moments as without it.

    ``mesh``: data parallel over the mesh's ranks, as the module's doc
    says; the batch holds this rank's rows (``parallel.shard_batch``), and
    the state is every rank's copy of one state (``parallel.shard_params``)
    or its shards (``parallel.shard_state_fsdp``, JAX's
    ``state_out_shardings``: the state stays sharded)."""
    if loss_name not in LOSS_NAMES:
        raise ValueError(f"unknown loss {loss_name!r}; one of {LOSS_NAMES}")
    group = None if mesh is None else mesh.get_group()

    def train_step(state: TrainState, batch: dict):
        model = state.model
        model.train(not freeze_bn)
        sharded = group is not None and _is_sharded(model)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with synced_statistics(model, group):
            if remat:
                out = checkpoint(
                    model, batch["img_left"], batch["img_right"],
                    iters=iters, use_reentrant=False,
                    context_fn=lambda: (contextlib.nullcontext(),
                                        frozen_statistics(model)))
            else:
                out = model(batch["img_left"], batch["img_right"],
                            iters=iters)
            gt = batch["gt_disp"]
            loss = compute_loss(loss_name, out, gt, gamma, weights, group)
            # FSDP2 averages the ranks' gradients; the shares need a sum
            (loss * group_size(group) if sharded else loss).backward()
        for p in params.values():
            if p.grad is None:
                # outside the loss (LowCNN_gru's mask head with
                # upsample="simple"): a zero gradient, as JAX gives it
                p.grad = torch.zeros_like(p)
        grads = {k: p.grad for k, p in params.items()}
        if group is not None and not sharded:
            _all_reduce_grads(list(grads.values()), group)
        with torch.no_grad():
            epe = losses.epe(out["disparities"][-1], gt, group)
            gnorm = global_norm(grads.values(), group if sharded else None)
            loss = global_sum(loss.detach(), group)
        tx.step(state.opt_state, params, grads)
        state.step += 1
        return state, {"loss": loss.detach(), "epe": epe, "grad_norm": gnorm}

    return train_step


def make_eval_step(iters: int = 12, mesh=None) -> Callable:
    """Returns ``eval_step(state, batch) -> {"epe", "p1", "pred"}``: the
    model in eval mode; the last prediction, resized to the ground truth's
    size with ``scale_disp`` where the two differ; EPE and the share of
    valid pixels off by more than 1 px. With ``mesh`` the batch is this
    rank's rows, ``pred`` this rank's, EPE and P1 the global batch's."""
    group = None if mesh is None else mesh.get_group()

    def eval_step(state: TrainState, batch: dict) -> dict:
        model = state.model.eval()
        with torch.inference_mode():
            out = model(batch["img_left"], batch["img_right"], iters=iters)
            pred = out["disparities"][-1]
            gt = batch["gt_disp"]
            if pred.shape[1:3] != gt.shape[1:3]:
                pred = scale_disp(pred, (gt.shape[1], gt.shape[2]))
            return {"epe": losses.epe(pred, gt, group),
                    "p1": thres_metric(pred, gt, losses.valid_mask(gt), 1.0,
                                       group),
                    "pred": pred}

    return eval_step


def make_infer_fn(iters: int = 12) -> Callable:
    """Returns ``infer(state, left, right) -> final disparity [B, H, W, 1]``,
    the model in eval mode."""

    def infer(state: TrainState, left, right):
        model = state.model.eval()
        with torch.inference_mode():
            return model(left, right, iters=iters)["disparities"][-1]

    return infer
