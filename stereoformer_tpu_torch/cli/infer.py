"""Single-pair inference with the port: predict the disparity of a stereo
pair and save it as PFM, 16-bit KITTI PNG (x256) or ``.npy``.

Usage:
  python -m stereoformer_tpu_torch.cli.infer --left l.png --right r.png \\
      --out disp.pfm [--weights model.pth] [--net LowCNN_gru|RAFT_Stereo] \\
      [--iters 12] [--device cuda]

``--weights`` takes a port or reference PyTorch ``state_dict``; without it
the weights are random (seed 0). Images are read as 8-bit RGB and
ImageNet-normalised, the convention both registered models take. Runs on the
GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("stereoformer_tpu_torch infer")
    p.add_argument("--weights", type=str, default=None,
                   help="port or reference .pth state_dict")
    p.add_argument("--net", type=str, default="LowCNN_gru")
    p.add_argument("--left", type=str, required=True)
    p.add_argument("--right", type=str, required=True)
    p.add_argument("--out", type=str, required=True,
                   help=".pfm, 16-bit KITTI .png (x256), or .npy")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--device", type=str, default="cuda")
    opt = p.parse_args(argv)

    import numpy as np
    import torch

    from ..data import normalize, read_img, to_unit, write_pfm
    from ..models import get_model
    from ..ops import InputPadder
    from ..weights import load_state_dict_file

    model = get_model(opt.net, device=opt.device, max_disp=opt.maxdisp)
    if opt.weights:
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
    return disp


if __name__ == "__main__":
    main()
