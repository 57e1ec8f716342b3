"""Checkpoint probing on one stereo pair: the disparity at a chosen pixel
before and after the refinement, against the ground truth, and EPE, D1 and
P1 of the pair; optionally an ``.npz`` of the disparities.

Counterpart of ``stereoformer_tpu/cli/analysis.py``, with its flags, its
printout and its ``.npz`` keys (``disp_low``, ``disp_final``, and ``gt``
with ``--disp``), plus ``--device``. Usage:
  python -m stereoformer_tpu_torch.cli.analysis --ckpt saved/model_best \\
      --left l.png --right r.png [--disp gt.pfm] [--pixel y x] \\
      [--out prob.npz] [--device cuda]

The images are cropped to multiples of 8. Runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser():
    p = argparse.ArgumentParser("stereoformer_tpu_torch analysis")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--net", type=str, default="LowCNN_gru")
    p.add_argument("--left", type=str, required=True)
    p.add_argument("--right", type=str, required=True)
    p.add_argument("--disp", type=str, default=None)
    p.add_argument("--pixel", type=int, nargs=2, default=(100, 100),
                   help="full-res (y, x) probe pixel")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--out", type=str, default=None,
                   help="save .npz with prob curve / disparities")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    return p


def main(argv=None):
    """Probe as the JAX CLI does; returns the report dict (numpy)."""
    opt = build_parser().parse_args(argv)

    import torch

    from .. import losses, metrics
    from ..data import normalize, read_disp, read_img, to_unit
    from ..models import get_model
    from ..train import TrainState, restore_params

    model = get_model(opt.net, device=opt.device)
    restore_params(opt.ckpt, TrainState(step=0, model=model, opt_state=None))
    device = next(model.parameters()).device

    sample = normalize(to_unit({
        "img_left": read_img(opt.left),
        "img_right": read_img(opt.right),
    }))
    H, W = sample["img_left"].shape[:2]
    H8, W8 = (H // 8) * 8, (W // 8) * 8
    left, right = (torch.from_numpy(np.ascontiguousarray(
        sample[k][None, :H8, :W8])).to(device)
        for k in ("img_left", "img_right"))
    with torch.inference_mode():
        out = model(left, right, iters=opt.iters)
    disp_low = out["disp_low"]                          # [1,H/8,W/8,1]
    final = out["disparities"][-1]                      # [1,H8,W8,1]

    y, x = opt.pixel
    y8, x8 = min(y // 8, H8 // 8 - 1), min(x // 8, W8 // 8 - 1)
    print(f"pixel ({y},{x}) -> 1/8 cell ({y8},{x8})")
    print(f"  initial 1/8 disparity: {float(disp_low[0, y8, x8, 0]) * 8:.3f} (full-res units)")
    print(f"  final disparity:       {float(final[0, y, x, 0]):.3f}")

    report: dict = {
        "disp_low": disp_low[0, ..., 0].cpu().numpy(),
        "disp_final": final[0, ..., 0].cpu().numpy(),
    }
    if opt.disp:
        gt = read_disp(opt.disp)[None, :H8, :W8, None]
        gt_t = torch.from_numpy(np.ascontiguousarray(gt)).to(device)
        print(f"  GT disparity:          {float(gt[0, y, x, 0]):.3f}")
        print(f"  EPE {float(losses.epe(final, gt_t)):.4f}"
              f"  D1 {float(metrics.d1_metric(final, gt_t)):.4f}"
              f"  P1 {float(metrics.p1_metric(final, gt_t)):.4f}")
        report["gt"] = gt[0, ..., 0]
    if opt.out:
        np.savez(opt.out, **report)
        print(f"saved {opt.out}")
    return report


if __name__ == "__main__":
    main()
