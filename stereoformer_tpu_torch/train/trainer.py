"""DisparityTrainer: the training loop of the port, on one device.

Counterpart of ``stereoformer_tpu/train/trainer.py::DisparityTrainer``:
``DisparityTrainer(lr, dataset, trainlist, vallist, datapath, batch_size,
maxdisp, pretrain, model, test_batch, ...).initialize()``, then
``train_one_epoch`` and ``validate``. The datasets and loaders, the model,
AMSGrad with the reference's per-epoch learning rate as a step schedule,
the loss-weight rounds and the checkpoint fallbacks are the JAX trainer's.
A step runs eagerly (``train/steps.py``) and updates the state in place;
batches reach the device through ``data.DevicePrefetcher``. Metrics stay
0-d tensors on the device and are read at log points and once at the end
of an epoch, as the JAX trainer reads them.

Not ported: the device mesh and FSDP (``mesh``, ``fsdp``), bf16
(``dtype="bf16"``) and the scanned GRU loop (``gru_loop="scan"``); each
raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..data import (
    DataLoader,
    DevicePrefetcher,
    DummyStereoDataset,
    StereoDataset,
    train_transform,
    val_transform,
)
from ..device import resolve_device
from ..utils import AverageMeter, get_logger
from .checkpoint import restore_checkpoint, restore_params
from .optim import Amsgrad
from .params import count_parameters
from .schedule import make_step_schedule, reference_lr
from .state import TrainState
from .steps import make_eval_step, make_train_step

logger = get_logger()

# the default loss of each model family (the reference trainer that used it)
_DEFAULT_LOSS = {
    "LowCNN_gru": "sequence",
    "LowCNN_gru2": "sequence",
    "LowCNN_dynamic_supervised": "range_supervised",
    "LowCNN_dynamic": "equal",
    "LowCNN_ada": "equal",
    "LowCNN": "single",
    "LowCNN_simple": "single",
}


def pad_batch_to(batch: dict, size: int) -> dict:
    """Zero-pad every array's batch dimension to ``size`` (the JAX
    package's ``parallel.pad_batch_to``)."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, "ndim") and v.shape[0] < size:
            pad = [(0, size - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
            out[k] = np.pad(np.asarray(v), pad)
        else:
            out[k] = v
    return out


class DisparityTrainer:
    def __init__(
        self,
        lr: float,
        dataset: str = "SceneFlow",
        trainlist: str = "",
        vallist: str = "",
        datapath: str = "",
        batch_size: int = 4,
        maxdisp: int = 192,
        pretrain: Optional[str] = None,
        model: str = "LowCNN_gru",
        test_batch: int = 4,
        loss: Optional[str] = None,
        loss_weights=None,
        train_iters: int = 12,
        eval_iters: int = 12,
        crop_size: tuple[int, int] = (320, 640),
        num_workers: Optional[int] = None,
        seed: int = 1024,
        mesh=None,
        remat: bool = False,
        fsdp: bool = False,
        color_aug: bool = False,
        dtype: Optional[str] = None,
        scale_size: Optional[tuple[int, int]] = None,
        filenames_dir: Optional[str] = None,
        gru_loop: str = "unroll",
        remat_update: bool = False,
        freeze_bn: bool = False,
        data_cache: Optional[str] = None,
        device="cuda",
    ):
        if mesh is not None or fsdp:
            raise NotImplementedError(
                "mesh and fsdp are not ported yet (data parallelism and "
                "sharded state come in a later slice); the port trains on "
                "one device")
        if dtype not in (None, "f32", "float32"):
            raise NotImplementedError(
                f"dtype={dtype!r} is not ported yet (bf16 comes in a later "
                f"slice); the port trains in float32")
        if gru_loop != "unroll":
            raise NotImplementedError(
                f"gru_loop={gru_loop!r} is not ported: it is the JAX "
                f"package's compile device; the port's GRU loop is unrolled")
        if remat_update and not model.startswith("RAFT"):
            raise ValueError("remat_update applies to the RAFT family only")
        self.lr = lr
        self.dataset = dataset
        self.trainlist, self.vallist = trainlist, vallist
        self.datapath = datapath
        self.batch_size, self.test_batch = batch_size, test_batch
        self.maxdisp = maxdisp
        self.pretrain = pretrain
        self.model_name = model
        self.loss_name = loss or _DEFAULT_LOSS.get(model, "sequence")
        self.loss_weights = tuple(loss_weights) if loss_weights else (0.8, 1.2)
        self.train_iters, self.eval_iters = train_iters, eval_iters
        self.crop_size = crop_size
        self.num_workers = num_workers
        self.seed = seed
        self.remat = remat
        self.filenames_dir = filenames_dir
        self.color_aug = color_aug
        self.remat_update = remat_update
        self.freeze_bn = freeze_bn
        self.data_cache = data_cache
        self.scale_size = scale_size
        self.device = resolve_device(device)
        self.current_lr = lr
        self.is_pretrain = False
        # one dict per train_one_epoch (see there)
        self.history: list = []

    # -- set-up --------------------------------------------------------------

    def _prepare_dataset(self):
        if self.dataset.startswith("dummy"):
            # "dummy" or "dummy:N" (N synthetic training pairs)
            n = (int(self.dataset.split(":", 1)[1]) if ":" in self.dataset
                 else max(self.batch_size * 4, 8))
            self.train_set = DummyStereoDataset(
                length=n, height=self.crop_size[0], width=self.crop_size[1],
                mode="train")
            self.val_set = DummyStereoDataset(
                length=max(self.test_batch * 2, 4),
                height=self.crop_size[0], width=self.crop_size[1],
                mode="val", seed=1)
        else:
            kw = {"scale_size": self.scale_size} if self.scale_size else {}
            if self.data_cache:
                kw["cache_dir"] = self.data_cache
            if self.filenames_dir:
                kw["filenames_dir"] = self.filenames_dir
            self.train_set = StereoDataset(
                self.datapath, self.trainlist, self.vallist,
                dataset_name=self.dataset, mode="train", **kw)
            self.val_set = StereoDataset(
                self.datapath, self.trainlist, self.vallist,
                dataset_name=self.dataset, mode="val", **kw)
        crop, color = self.crop_size, self.color_aug
        pin = self.device.type == "cuda"
        self.train_loader = DataLoader(
            self.train_set, self.batch_size, shuffle=True,
            num_workers=self.num_workers, seed=self.seed,
            transform_with_rng=lambda s, rng: train_transform(
                s, rng, crop=crop, color=color),
            pin_memory=pin)
        self.val_loader = DataLoader(
            self.val_set, self.test_batch, shuffle=False,
            num_workers=self.num_workers, drop_last=False, seed=self.seed,
            transform_with_rng=lambda s, rng: val_transform(s))
        self.steps_per_epoch = max(len(self.train_loader), 1)

    def _build_net(self):
        # models and weights import train (the optimizer state)
        from ..models import get_model
        from ..weights import init_state_dict

        kw = {"remat_update": True} if self.remat_update else {}
        self.net = get_model(self.model_name, device=self.device,
                             max_disp=self.maxdisp, **kw)
        # from scratch: the JAX models' distributions, drawn from the seed
        self.net.load_state_dict(init_state_dict(self.net, seed=self.seed))
        logger.info("Number of model parameters: %d",
                    count_parameters(self.net))

    def _build_optimizer(self):
        schedule = make_step_schedule(self.lr, self.steps_per_epoch)
        self.tx = Amsgrad(schedule, b1=0.9, b2=0.999)
        self.state = TrainState.create(self.net, self.tx)

    def _make_train_step(self):
        return make_train_step(self.tx, self.loss_name, iters=self.train_iters,
                               weights=self.loss_weights, remat=self.remat,
                               freeze_bn=self.freeze_bn)

    def initialize(self):
        self._prepare_dataset()
        self._build_net()
        self._build_optimizer()
        self.train_step = self._make_train_step()
        self.eval_step = make_eval_step(iters=self.eval_iters)
        if self.pretrain and self.pretrain != "none":
            try:
                self.state = restore_checkpoint(self.pretrain, self.state)
                self.is_pretrain = True
                logger.info("Loaded pretrain checkpoint: %s", self.pretrain)
            except Exception as e:
                # parameters only, moments fresh: a checkpoint without
                # optimizer state (a reference or port state_dict file)
                try:
                    self.state = restore_params(self.pretrain, self.state)
                    self.is_pretrain = True
                    logger.info("Loaded pretrain params (optimizer state "
                                "fresh): %s", self.pretrain)
                except Exception:
                    logger.warning("Cannot load %s (%s); starting fresh",
                                   self.pretrain, e)

    def set_loss_weights(self, weights):
        """Swap the per-round loss weights (the loss-schedule file's
        rounds); the step is rebuilt when they change."""
        w = tuple(weights)
        if w == self.loss_weights:
            return
        self.loss_weights = w
        self.train_step = self._make_train_step()

    # -- epoch loops ---------------------------------------------------------

    def adjust_learning_rate(self, epoch: int) -> float:
        """The rate of ``epoch``, for the log: the optimizer reads it from
        the step schedule at its own count."""
        self.current_lr = float(reference_lr(self.lr, epoch))
        return self.current_lr

    def _prefetched(self, loader):
        return DevicePrefetcher(loader, self.device)

    def train_one_epoch(self, epoch: int, round_idx: int, iterations: int,
                        summary_writer=None, log_every: int = 10):
        """One epoch; returns (mean loss, mean EPE, iterations). The
        metrics stay on the device and are read at log points and once at
        the end. Appends to ``history`` the epoch, its step count, mean loss
        and EPE, the seconds from its start to its last metric (which waits
        for the device), the seconds spent waiting for batches, and of
        those the wait for the first (the pipeline filling up)."""
        self.adjust_learning_rate(epoch)
        self.train_loader.set_epoch(epoch)
        batch_time, data_time = AverageMeter(), AverageMeter()
        device_metrics: list = []
        start_iter = iterations
        t0 = end = time.perf_counter()
        for i_batch, batch in enumerate(self._prefetched(self.train_loader)):
            data_time.update(time.perf_counter() - end)
            if i_batch == 0:
                first_wait = data_time.val
            self.state, metrics = self.train_step(self.state, batch)
            device_metrics.append((metrics["loss"], metrics["epe"]))
            batch_time.update(time.perf_counter() - end)
            end = time.perf_counter()
            iterations += 1
            if i_batch % log_every == 0:
                loss, epe = (float(x) for x in device_metrics[-1])
                logger.info(
                    "Epoch [%d][%d/%d] time %.3f (%.3f) data %.3f loss %.3f "
                    "EPE %.3f", epoch, i_batch, len(self.train_loader),
                    batch_time.val, batch_time.avg, data_time.avg, loss, epe)
                end = time.perf_counter()  # the read is not data time
        if not device_metrics:
            return 0.0, 0.0, iterations
        # one transfer for the whole epoch
        stacked = torch.stack([torch.stack(m) for m in device_metrics]
                              ).cpu().numpy()
        losses_np, epes_np = stacked[:, 0], stacked[:, 1]
        self.history.append({
            "epoch": epoch, "steps": len(device_metrics),
            "loss": float(losses_np.mean()), "epe": float(epes_np.mean()),
            "seconds": time.perf_counter() - t0, "data_s": data_time.sum,
            "first_data_s": first_wait})
        if summary_writer is not None:
            for i, (loss, epe) in enumerate(zip(losses_np, epes_np)):
                summary_writer.add_scalar("total_loss", float(loss),
                                          start_iter + i)
                summary_writer.add_scalar("epe", float(epe), start_iter + i)
            summary_writer.add_scalar("Learning_Rate", self.current_lr, epoch)
        return float(losses_np.mean()), float(epes_np.mean()), iterations

    def validate(self, summary_writer=None, epoch: int = 0):
        """EPE over the validation set (a last partial batch is padded to
        ``test_batch`` with samples of zero ground truth, which every
        metric masks out)."""
        epes_m, p1_m, inf_t = AverageMeter(), AverageMeter(), AverageMeter()
        logged_images = False
        for batch in self.val_loader:
            n = batch["img_left"].shape[0]     # the true sample count
            arrays = {k: v for k, v in batch.items()
                      if isinstance(v, np.ndarray)}
            if n < self.test_batch:
                arrays = pad_batch_to(arrays, self.test_batch)
            dev = {k: torch.from_numpy(v).to(self.device)
                   for k, v in arrays.items()}
            t0 = time.perf_counter()
            metrics = self.eval_step(self.state, dev)
            epe = float(metrics["epe"])    # waits for the device
            dt = time.perf_counter() - t0
            p1 = float(metrics["p1"])
            if np.isfinite(epe):
                epes_m.update(epe, n)
            if np.isfinite(p1):
                p1_m.update(p1, n)
            inf_t.update(dt / n, n)
            if summary_writer is not None and not logged_images:
                from ..utils.viz import tensorboard_disparity_images

                tensorboard_disparity_images(
                    summary_writer, "val", arrays["img_left"][0],
                    metrics["pred"][0, ..., 0].cpu().numpy(),
                    arrays["gt_disp"][0, ..., 0], epoch)
                logged_images = True
        if summary_writer is not None:
            summary_writer.add_scalar("epe_on_val", epes_m.avg, epoch)
        logger.info("Validate epoch %d: EPE %.4f P1 %.4f inference %.4fs/img",
                    epoch, epes_m.avg, p1_m.avg, inf_t.avg)
        return epes_m.avg

    def get_model(self):
        return self.state
