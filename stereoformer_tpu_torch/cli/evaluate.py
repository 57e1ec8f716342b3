"""Evaluation of the port over a validation split: EPE, P1, D1 and the
inference time per image, printed as one JSON line.

Counterpart of ``stereoformer_tpu/cli/evaluate.py``, with its flags and its
JSON keys (``net``, ``dataset``, ``iters``, ``EPE``, ``P1``, ``D1``,
``s_per_image``, ``images``), plus ``--device``. Usage:
  python -m stereoformer_tpu_torch.cli.evaluate --ckpt saved/model_best \\
      --dataset SceneFlow --vallist filenames/SceneFlow_finalpass_val.txt \\
      --datapath /data/sceneflow [--net LowCNN_gru] [--iters 12] \\
      [--device cuda]
  # or synthetic pairs: --dataset dummy

``--ckpt`` takes a port checkpoint (``cli.train``'s, or one that
``scripts/jax_ckpt_to_torch.py`` made from a JAX checkpoint) or a port or
reference ``state_dict`` file; without it the weights are random (seed 0).
A prediction whose size differs from the ground truth's is resized to it
(``ops.scale_disp``); a batch whose EPE is not finite (no valid pixel) is
left out of the averages. The time per image is the batch's time on the
device, synchronised, over its pairs. Runs on the GPU unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    """Evaluate as the JAX CLI does; prints and returns the result dict."""
    p = argparse.ArgumentParser("stereoformer_tpu_torch evaluate")
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--net", type=str, default="LowCNN_gru")
    p.add_argument("--dataset", type=str, default="SceneFlow")
    p.add_argument("--trainlist", type=str, default="")
    p.add_argument("--vallist", type=str, default="")
    p.add_argument("--datapath", type=str, default="")
    p.add_argument("--test_batch", type=int, default=4)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--crop_h", type=int, default=320)
    p.add_argument("--crop_w", type=int, default=640)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    opt = p.parse_args(argv)

    import numpy as np
    import torch

    from .. import losses, metrics
    from ..data import (
        DataLoader,
        DummyStereoDataset,
        StereoDataset,
        val_transform,
    )
    from ..models import get_model
    from ..ops import scale_disp
    from ..train import TrainState, restore_params
    from ..utils import AverageMeter, get_logger

    logger = get_logger()
    model = get_model(opt.net, device=opt.device, max_disp=opt.maxdisp)
    if opt.ckpt:
        restore_params(opt.ckpt, TrainState(step=0, model=model,
                                            opt_state=None))
        logger.info("restored %s", opt.ckpt)
    device = next(model.parameters()).device

    if opt.dataset == "dummy":
        val_set = DummyStereoDataset(
            length=8, height=opt.crop_h, width=opt.crop_w, mode="val", seed=1)
    else:
        val_set = StereoDataset(
            opt.datapath, opt.trainlist, opt.vallist,
            dataset_name=opt.dataset, mode="val")
    loader = DataLoader(
        val_set, opt.test_batch, shuffle=False, drop_last=False,
        num_workers=opt.workers,
        transform_with_rng=lambda s, rng: val_transform(s))

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    epe_m, p1_m, d1_m, t_m = (AverageMeter() for _ in range(4))
    for batch in loader:
        left, right, gt = (torch.from_numpy(batch[k]).to(device) for k in
                           ("img_left", "img_right", "gt_disp"))
        n = left.shape[0]
        synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            pred = model(left, right, iters=opt.iters)["disparities"][-1]
            if pred.shape[1:3] != gt.shape[1:3]:
                pred = scale_disp(pred, (gt.shape[1], gt.shape[2]))
            m = {"epe": losses.epe(pred, gt),
                 "p1": metrics.p1_metric(pred, gt),
                 "d1": metrics.d1_metric(pred, gt)}
            m = {k: float(v) for k, v in m.items()}    # waits for the device
        t_m.update((time.perf_counter() - t0) / n, n)
        if np.isfinite(m["epe"]):
            epe_m.update(m["epe"], n)
            p1_m.update(m["p1"], n)
            d1_m.update(m["d1"], n)
    result = {
        "net": opt.net, "dataset": opt.dataset, "iters": opt.iters,
        "EPE": round(epe_m.avg, 4), "P1": round(p1_m.avg, 4),
        "D1": round(d1_m.avg, 4), "s_per_image": round(t_m.avg, 4),
        "images": epe_m.count,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
