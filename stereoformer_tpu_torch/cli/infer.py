"""Single-pair inference with the port: predict the disparity of a stereo
pair and save it as PFM, 16-bit KITTI PNG (x256) or ``.npy``; with a ground
truth, also a KITTI error map and the EPE.

Counterpart of ``stereoformer_tpu/cli/infer.py``. Usage:
  python -m stereoformer_tpu_torch.cli.infer --left l.png --right r.png \\
      --out disp.pfm [--ckpt saved/model_best | --weights model.pth] \\
      [--gt gt.pfm --error-out err.png] [--net NAME] [--iters 12] \\
      [--device cuda]

``--net`` is a name of the port's registry (``models.available_models()``,
all nine of the JAX registry's; ``LowCNN_gru`` by default); ``--iters`` is
read only by the GRU models and RAFT. ``--ckpt`` takes a port checkpoint
(``cli.train``'s, or one that ``scripts/jax_ckpt_to_torch.py`` made from a
JAX checkpoint), read as the JAX CLI reads its own (``restore_params``);
``--weights`` a port or reference PyTorch ``state_dict``; without either the
weights are random (seed 0). Images are read as 8-bit RGB and
ImageNet-normalised, the convention every registered model takes. With
``--gt`` and ``--error-out`` the error map against the ground truth is
written as a PNG and the EPE over its valid (> 0) pixels printed. Runs on
the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Predict as the JAX CLI does; returns the disparity [H, W] (numpy)."""
    p = argparse.ArgumentParser("stereoformer_tpu_torch infer")
    weights = p.add_mutually_exclusive_group()
    weights.add_argument("--ckpt", type=str, default=None,
                         help="port checkpoint (cli.train's model_best, ...)")
    weights.add_argument("--weights", type=str, default=None,
                         help="port or reference .pth state_dict")
    p.add_argument("--net", type=str, default="LowCNN_gru")
    p.add_argument("--left", type=str, required=True)
    p.add_argument("--right", type=str, required=True)
    p.add_argument("--out", type=str, required=True,
                   help=".pfm, 16-bit KITTI .png (x256), or .npy")
    p.add_argument("--gt", type=str, default=None)
    p.add_argument("--error-out", type=str, default=None)
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--device", type=str, default="cuda")
    opt = p.parse_args(argv)

    import numpy as np
    import torch

    from ..data import normalize, read_disp, read_img, to_unit, write_pfm
    from ..models import get_model
    from ..ops import InputPadder
    from ..train import TrainState, restore_params
    from ..utils import disp_error_image
    from ..weights import load_state_dict_file

    model = get_model(opt.net, device=opt.device, max_disp=opt.maxdisp)
    if opt.ckpt:
        restore_params(opt.ckpt, TrainState(step=0, model=model,
                                            opt_state=None))
    elif opt.weights:
        model.load_state_dict(load_state_dict_file(opt.weights))
    device = next(model.parameters()).device

    sample = normalize(to_unit({
        "img_left": read_img(opt.left),
        "img_right": read_img(opt.right),
    }))
    left = torch.from_numpy(sample["img_left"])[None].to(device)
    right = torch.from_numpy(sample["img_right"])[None].to(device)
    padder = InputPadder(left.shape, divisor=8)
    left_p, right_p = padder.pad(left, right)
    with torch.inference_mode():
        out = model(left_p, right_p, iters=opt.iters)["disparities"][-1]
    disp = padder.unpad(out)[0, ..., 0].cpu().numpy()

    if opt.out.lower().endswith(".pfm"):
        write_pfm(opt.out, disp)
    elif opt.out.lower().endswith(".png"):
        from PIL import Image

        Image.fromarray(
            np.clip(disp * 256.0, 0, 65535).astype(np.uint16)).save(opt.out)
    else:
        np.save(opt.out, disp)
    print(f"wrote {opt.out} (range {disp.min():.2f}..{disp.max():.2f})")

    if opt.gt and opt.error_out:
        from PIL import Image

        gt = read_disp(opt.gt)
        Image.fromarray(disp_error_image(disp, gt)).save(opt.error_out)
        valid = gt > 0
        epe = (float(np.abs(disp - gt)[valid].mean()) if valid.any()
               else float("nan"))
        print(f"wrote {opt.error_out} (EPE {epe:.6f})")
    return disp


if __name__ == "__main__":
    main()
