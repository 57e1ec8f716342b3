"""Training CLI of the port, with the JAX package's flags:

  python -m stereoformer_tpu_torch.cli.train --net LowCNN_gru \\
      --loss config/loss_config_disp.json --dataset SceneFlow \\
      --trainlist filenames/... --vallist filenames/... --datapath DIR \\
      [--device cuda] [--resume] ...

Counterpart of ``stereoformer_tpu/cli/train.py``: rounds and epochs from
the loss-schedule file (or ``--epochs``), a validation and a checkpoint
``{net}_{round}_{epoch}_{EPE:.3f}`` after every epoch, ``model_best`` for
the best EPE, ``--resume`` from the latest complete checkpoint in
``--outf``. ``--dataset dummy`` (or ``dummy:N``) trains on synthetic pairs.
Runs on the GPU unless ``--device cpu`` is given.

Data parallel, one process (rank) a device, as the JAX CLI's mesh over its
devices: under a launcher (``torchrun --nproc_per_node N -m
stereoformer_tpu_torch.cli.train ...``, which sets ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) each rank
takes ``cuda:LOCAL_RANK`` (NCCL; with ``--device cpu`` the CPU, gloo).
Without one, ``--devices 0,1`` starts one process per listed card (spawned
here, on a free local port) and ``--devices all`` one per visible card; a
single card, or ``--no_mesh``, trains in this process with no group, as
the JAX CLI does without a mesh. ``--fsdp`` shards the parameters and the
AMSGrad state over the ranks (ZeRO-style, ``parallel.fsdp``); with no
group it is ignored, as in JAX. ``--batch_size`` and ``--test_batch`` are
global and must divide by the ranks. Rank 0 logs, writes TensorBoard
scalars and saves the checkpoints, which hold whole tensors and load in
one process.

``--dtype bf16`` (or ``bfloat16``) trains in bf16 as the JAX CLI does: the
net computes in bf16, and the parameters, the AMSGrad state and the
checkpoints stay float32, so ``--resume`` continues a bf16 run. ``--dtype``
is free text, as the JAX CLI's is; a value other than f32, float32, bf16
or bfloat16 raises, naming it.

Not ported, and raising: ``--gru_loop scan``. Accepted and ignored:
``--use_deform`` (as in the JAX CLI) and ``--scan_unroll`` (a knob of the
scanned loop; set under ``--gru_loop unroll`` it warns, as in JAX).
``--profile_dir`` writes a ``torch.profiler`` trace of the first epoch.
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import logging
import os
import random
import signal
import socket
import sys
import warnings

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("stereoformer_tpu_torch train")
    p.add_argument("--net", type=str, default="LowCNN_gru")
    p.add_argument("--loss", type=str, default=None,
                   help="loss-schedule JSON (config/loss_config_disp.json)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--devices", type=str, default="all",
                   help="'all' (every card) or a comma list of card "
                        "indices; two or more train data parallel, one "
                        "process a card")
    p.add_argument("--dataset", type=str, default="SceneFlow")
    p.add_argument("--trainlist", type=str, default="")
    p.add_argument("--vallist", type=str, default="")
    p.add_argument("--datapath", type=str, default="")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--test_batch", type=int, default=4)
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--use_deform", action="store_true",
                   help="accepted and ignored, as in the JAX CLI")
    p.add_argument("--pretrain", type=str, default="none")
    p.add_argument("--outf", type=str, default="./saved_models")
    p.add_argument("--save_logdir", type=str, default="./logs")
    p.add_argument("--startRound", type=int, default=0)
    p.add_argument("--startEpoch", type=int, default=0)
    p.add_argument("--manualSeed", type=int, default=1024)
    p.add_argument("--train_iters", type=int, default=12,
                   help="GRU iterations in training")
    p.add_argument("--eval_iters", type=int, default=12)
    p.add_argument("--loss_name", type=str, default=None,
                   choices=[None, "sequence", "equal", "single",
                            "range_supervised"])
    p.add_argument("--crop_h", type=int, default=320)
    p.add_argument("--crop_w", type=int, default=640)
    p.add_argument("--scale_h", type=int, default=576,
                   help="val/test image resize height")
    p.add_argument("--scale_w", type=int, default=960)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--filenames_dir", type=str, default=None,
                   help="directory of the KITTI/ETH3D/Middlebury list "
                        "registry (default: ./filenames)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward "
                        "(torch.utils.checkpoint): less memory, same values")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters and optimizer state over the "
                        "data-parallel ranks (ignored with one)")
    p.add_argument("--dtype", type=str, default=None,
                   help="compute dtype: f32 (the default) or bf16 "
                        "(parameters and optimizer state stay float32)")
    p.add_argument("--color_aug", action="store_true")
    p.add_argument("--no_mesh", action="store_true",
                   help="train in this process on one device, with no "
                        "process group")
    p.add_argument("--epochs", type=int, default=None,
                   help="override epochs per round")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --outf")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the first epoch here")
    p.add_argument("--gru_loop", type=str, default="unroll",
                   choices=["unroll", "scan"],
                   help="the GRU loop; scan is the JAX package's compile "
                        "device, not ported, and raises")
    p.add_argument("--scan_unroll", type=int, default=1,
                   help="accepted and ignored (a knob of --gru_loop scan)")
    p.add_argument("--remat_update", action="store_true",
                   help="RAFT only: checkpoint each GRU-cascade iteration")
    p.add_argument("--freeze_bn", action="store_true",
                   help="BatchNorm uses and keeps its running statistics "
                        "(the RAFT fine-tune knob)")
    p.add_argument("--data_cache", default=None, metavar="DIR",
                   help="decoded-sample disk cache: from the second epoch "
                        "on, no PNG/PFM decode (data/cache.py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    return p


def _devices(opt) -> list:
    """The devices --devices names: CUDA cards by index (``all``: every
    visible card), or, with ``--device cpu``, that many CPU ranks."""
    import torch

    if opt.devices in ("all", ""):
        if opt.device != "cuda":
            return [opt.device]
        return [f"cuda:{i}" for i in range(max(torch.cuda.device_count(),
                                               1))]
    idx = opt.devices.split(",")
    if not all(i.strip().isdigit() for i in idx):
        raise ValueError(f"--devices {opt.devices!r}: 'all' or a comma list "
                         f"of indices")
    if opt.device != "cuda":
        return [opt.device] * len(idx)
    return [f"cuda:{int(i)}" for i in idx]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned_rank(rank: int, argv: list, devices: list, port: int) -> None:
    """One rank of a --devices run: the launcher's environment, then
    main."""
    dev = devices[rank]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(len(devices)), RANK=str(rank),
                      LOCAL_RANK=dev.partition(":")[2] or "0")
    main(argv)


def _spawn(argv, devices: list) -> None:
    """One process per device, started with ``spawn``; raises if a rank
    fails."""
    import torch.multiprocessing as mp

    mp.start_processes(_spawned_rank,
                       args=(list(sys.argv[1:] if argv is None else argv),
                             devices, _free_port()),
                       nprocs=len(devices), start_method="spawn")


def main(argv=None):
    """Train as the JAX CLI does; returns the trainer (None where it
    started a process per device)."""
    opt = build_parser().parse_args(argv)
    if opt.scan_unroll != 1 and opt.gru_loop == "unroll":
        warnings.warn(
            "--scan_unroll only applies with --gru_loop scan; the fully "
            "unrolled loop ignores it.", stacklevel=1)
    if opt.gru_loop != "unroll":
        raise NotImplementedError(
            "--gru_loop scan is not ported: it is the JAX package's compile "
            "device; the port's GRU loop is unrolled")
    import torch

    from ..device import resolve_device
    from ..parallel import initialize_multihost, make_mesh
    from ..train import (
        DisparityTrainer,
        finalize_checkpoints,
        latest_checkpoint,
        save_checkpoint,
    )
    from ..train.checkpoint import checkpoint_meta
    from ..train.trainer import DTYPE_NAMES
    from ..utils import get_logger, load_loss_scheme

    if opt.dtype not in DTYPE_NAMES:
        raise ValueError(f"--dtype {opt.dtype!r}: one of "
                         f"{[k for k in DTYPE_NAMES if k]}")
    launched = "WORLD_SIZE" in os.environ and not opt.no_mesh
    if launched:
        device = resolve_device(
            f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            if opt.device == "cuda" else opt.device)
    else:
        devices = _devices(opt)
        if len(devices) > 1 and not opt.no_mesh:
            resolve_device(devices[0])      # raises before any process starts
            return _spawn(argv, devices)
        device = resolve_device(devices[0])  # raises before any file is made
    mesh = None
    if launched:
        initialize_multihost(device=device)
        mesh = make_mesh()
    main_rank = mesh is None or mesh.get_rank() == 0
    # live diagnosis: `kill -USR1 <pid>` dumps every thread's stack to
    # stderr without stopping training
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    os.makedirs(opt.outf, exist_ok=True)
    os.makedirs(opt.save_logdir, exist_ok=True)
    logger = get_logger(os.path.join(opt.outf, "train.log")
                        if main_rank else None)
    if not main_rank:
        logger.setLevel(logging.WARNING)

    random.seed(opt.manualSeed)
    np.random.seed(opt.manualSeed)
    torch.manual_seed(opt.manualSeed)

    if opt.loss:
        scheme = load_loss_scheme(opt.loss)
        train_round = scheme["round"]
        epochs = scheme["epoches"]
        loss_weights = scheme.get("loss_weights")
    else:
        train_round, epochs, loss_weights = 1, [opt.epochs or 70], None
    if opt.epochs is not None:
        epochs = [opt.epochs] * train_round

    if opt.resume:
        latest = latest_checkpoint(opt.outf, opt.net)
        if latest:
            opt.pretrain = latest
            meta = checkpoint_meta(latest)
            opt.startRound = meta.get("round", opt.startRound)
            opt.startEpoch = meta.get("epoch", opt.startEpoch) + 1
    logger.info("device: %s, mesh: %s", device, mesh)

    trainer = DisparityTrainer(
        lr=opt.lr,
        dataset=opt.dataset,
        trainlist=opt.trainlist,
        vallist=opt.vallist,
        datapath=opt.datapath,
        batch_size=opt.batch_size,
        maxdisp=opt.maxdisp,
        pretrain=opt.pretrain,
        model=opt.net,
        test_batch=opt.test_batch,
        loss=opt.loss_name,
        loss_weights=(loss_weights[opt.startRound]
                      if loss_weights else None),  # per round below
        train_iters=opt.train_iters,
        eval_iters=opt.eval_iters,
        crop_size=(opt.crop_h, opt.crop_w),
        num_workers=opt.workers,
        seed=opt.manualSeed,
        mesh=mesh,
        remat=opt.remat,
        fsdp=opt.fsdp and mesh is not None,
        color_aug=opt.color_aug,
        dtype=opt.dtype,
        scale_size=(opt.scale_h, opt.scale_w),
        filenames_dir=opt.filenames_dir,
        freeze_bn=opt.freeze_bn,
        remat_update=opt.remat_update,
        scan_unroll=opt.scan_unroll,
        data_cache=opt.data_cache,
        device=device,
    )
    trainer.initialize()

    writer = None
    try:
        if main_rank:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(opt.save_logdir)
    except ImportError:
        logger.info("tensorboard unavailable; scalar logging to stdout only")

    best_epe, best_index = -1.0, 0
    if trainer.is_pretrain:
        best_epe = trainer.validate(writer, epoch=opt.startEpoch)

    iterations = 0
    start_epoch = opt.startEpoch
    for r in range(opt.startRound, train_round):
        end_epoch = epochs[r] if r < len(epochs) else epochs[-1]
        logger.info("round %d (%d epochs)%s", r, end_epoch,
                    f" weights {loss_weights[r]}" if loss_weights else "")
        if loss_weights and r < len(loss_weights):
            trainer.set_loss_weights(loss_weights[r])
        for i in range(start_epoch, end_epoch):
            if opt.profile_dir and i == start_epoch and r == opt.startRound:
                avg_loss, avg_epe, iterations = _profiled_epoch(
                    trainer, opt.profile_dir, i, r, iterations, writer)
            else:
                avg_loss, avg_epe, iterations = trainer.train_one_epoch(
                    i, r, iterations, writer)
            val_epe = trainer.validate(writer, i)
            is_best = best_epe < 0 or val_epe < best_epe
            if is_best:
                best_epe, best_index = val_epe, i
            save_checkpoint(opt.outf, trainer.get_model(), opt.net, r, i,
                            val_epe, is_best)
            logger.info(
                "Validation[epoch:%d]: %s loss %.4f trainEPE %.4f valEPE %.4f "
                "lr %.2e", i,
                datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
                avg_loss, avg_epe, val_epe, trainer.current_lr)
            logger.info("min epe from epoch %d", best_index)
        start_epoch = 0
    finalize_checkpoints()
    if writer is not None:
        writer.close()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return trainer


def _profiled_epoch(trainer, profile_dir, epoch, round_idx, iterations,
                    writer):
    """One epoch under ``torch.profiler`` (host, and the card where there
    is one), its trace written to ``profile_dir`` as a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = trainer.train_one_epoch(epoch, round_idx, iterations, writer)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
    prof.export_chrome_trace(
        os.path.join(profile_dir, f"train_epoch{epoch}.trace.json"))
    return out


if __name__ == "__main__":
    main()
