"""Train, eval and inference steps.

Counterpart of ``stereoformer_tpu/train/steps.py``: forward, loss, backward,
optimizer update, BatchNorm statistics and metrics of one batch. PyTorch runs
eagerly, so a step is a plain function; it updates the state in place, as the
JAX step's donated state is reused. The model is the state's.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .. import losses
from ..metrics import thres_metric
from ..ops import scale_disp
from .optim import Amsgrad
from .state import TrainState

LOSS_NAMES = ("sequence", "equal", "single", "range_supervised")


def compute_loss(loss_name: str, out: dict, gt: torch.Tensor,
                 gamma: float = 0.8, weights: Sequence[float] = (0.8, 1.2)):
    preds = out["disparities"]
    if loss_name == "sequence":
        return losses.sequence_loss(preds, gt, gamma=gamma)
    if loss_name == "equal":
        return losses.multi_equal_loss(preds, gt, weights=weights)
    if loss_name == "single":
        return losses.single_scale_loss(preds[-1], gt)
    if loss_name == "range_supervised":
        lower, upper = out["bounds"]
        return losses.range_and_disparity_loss(
            preds, gt, out["disp_low"], lower, upper, weights=weights)
    raise ValueError(f"unknown loss {loss_name!r}; one of {LOSS_NAMES}")


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all the tensors together, as ``optax.global_norm``."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def make_train_step(tx: Amsgrad, loss_name: str = "sequence",
                    iters: int = 12, gamma: float = 0.8,
                    weights: Sequence[float] = (0.8, 1.2),
                    freeze_bn: bool = False) -> Callable:
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

    Not ported: ``remat`` (the JAX step's ``jax.checkpoint``) and
    ``state_out_shardings``."""
    if loss_name not in LOSS_NAMES:
        raise ValueError(f"unknown loss {loss_name!r}; one of {LOSS_NAMES}")

    def train_step(state: TrainState, batch: dict):
        model = state.model
        model.train(not freeze_bn)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        out = model(batch["img_left"], batch["img_right"], iters=iters)
        gt = batch["gt_disp"]
        loss = compute_loss(loss_name, out, gt, gamma, weights)
        loss.backward()
        for p in params.values():
            if p.grad is None:
                # outside the loss (LowCNN_gru's mask head with
                # upsample="simple"): a zero gradient, as JAX gives it
                p.grad = torch.zeros_like(p)
        grads = {k: p.grad for k, p in params.items()}
        with torch.no_grad():
            epe = losses.epe(out["disparities"][-1], gt)
            gnorm = global_norm(grads.values())
        tx.step(state.opt_state, params, grads)
        state.step += 1
        return state, {"loss": loss.detach(), "epe": epe, "grad_norm": gnorm}

    return train_step


def make_eval_step(iters: int = 12) -> Callable:
    """Returns ``eval_step(state, batch) -> {"epe", "p1", "pred"}``: the
    model in eval mode; the last prediction, resized to the ground truth's
    size with ``scale_disp`` where the two differ; EPE and the share of
    valid pixels off by more than 1 px."""

    def eval_step(state: TrainState, batch: dict) -> dict:
        model = state.model.eval()
        with torch.inference_mode():
            out = model(batch["img_left"], batch["img_right"], iters=iters)
            pred = out["disparities"][-1]
            gt = batch["gt_disp"]
            if pred.shape[1:3] != gt.shape[1:3]:
                pred = scale_disp(pred, (gt.shape[1], gt.shape[2]))
            return {"epe": losses.epe(pred, gt),
                    "p1": thres_metric(pred, gt, losses.valid_mask(gt), 1.0),
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
