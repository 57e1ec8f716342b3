"""Export a (trained) model to one ``torch.export`` serving artifact.

Counterpart of ``stereoformer_tpu/cli/export.py``: the deployment unit is
ONE file that a server runs with torch and the port's ops alone, no model
code (see stereoformer_tpu_torch/export.py). Usage:
  python -m stereoformer_tpu_torch.cli.export --ckpt saved/model_best \\
      --net LowCNN_gru --height 576 --width 960 --iters 12 \\
      --out lowcnn_gru_576x960.pt2 [--batch 8] [--check] [--device cuda]

``--batch 0`` (default) exports a symbolic batch dimension: one artifact,
any batch size (up to ``export.MAX_BATCH``). ``--ckpt`` takes a port
checkpoint, read as ``cli.infer`` reads it (``restore_params``);
``--weights`` a port or reference PyTorch ``state_dict``; without either
the weights are random (seed 0). The
artifact runs on the device it was exported on: the GPU unless ``--device
cpu`` is given. ``--loop scan`` raises: the port's GRU loop is unrolled.
JAX's ``--platforms`` (its lowering targets) has no counterpart; the
record's ``platforms`` names the device type. ``--check`` loads the file
and compares it with the live model on random inputs at B = ``--batch`` or
2, within 1e-2 px. Prints one JSON summary line.
"""

from __future__ import annotations

import argparse
import json

# the largest |artifact - live model| in px that --check accepts (JAX's)
CHECK_TOL_PX = 1e-2


def main(argv=None):
    """Export as the JAX CLI does; returns the JSON record."""
    p = argparse.ArgumentParser("stereoformer_tpu_torch export")
    weights = p.add_mutually_exclusive_group()
    weights.add_argument("--ckpt", type=str, default=None,
                         help="port checkpoint (params-only restore); omit "
                              "for randomly-initialised weights")
    weights.add_argument("--weights", type=str, default=None,
                         help="port or reference .pth state_dict")
    p.add_argument("--net", type=str, default="LowCNN_gru")
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--batch", type=int, default=0,
                   help="0 = symbolic (any batch size at serve time)")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--maxdisp", type=int, default=192)
    p.add_argument("--loop", type=str, default="unroll",
                   choices=("scan", "unroll"),
                   help="the GRU loop; scan is the JAX package's compile "
                        "device and is not ported")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--check", action="store_true",
                   help="load the artifact and compare it with the live "
                        "model on random inputs")
    p.add_argument("--device", type=str, default="cuda")
    opt = p.parse_args(argv)
    if opt.loop != "unroll":
        raise NotImplementedError(
            "--loop scan is not ported: it is the JAX package's compile "
            "device; the port's GRU loop is unrolled")

    import numpy as np
    import torch

    from .. import export as sfx
    from ..models import get_model
    from ..train import TrainState, restore_params
    from ..weights import load_state_dict_file

    model = get_model(opt.net, device=opt.device, max_disp=opt.maxdisp,
                      loop=opt.loop)
    if opt.ckpt:
        restore_params(opt.ckpt, TrainState(step=0, model=model,
                                            opt_state=None))
    elif opt.weights:
        model.load_state_dict(load_state_dict_file(opt.weights))
    device = next(model.parameters()).device

    exported = sfx.export_model(model, opt.height, opt.width,
                                iters=opt.iters, batch=opt.batch or None)
    nbytes = sfx.save_exported(exported, opt.out)
    record = {
        "artifact": opt.out,
        "bytes": nbytes,
        "net": opt.net,
        "resolution": f"{opt.height}x{opt.width}",
        "batch": opt.batch or "symbolic",
        "iters": opt.iters,
        "platforms": [device.type],
    }

    if opt.check:
        loaded = sfx.load_exported(opt.out)
        rng = np.random.RandomState(0)
        B = opt.batch or 2
        left, right = (torch.from_numpy(
            rng.randn(B, opt.height, opt.width, 3).astype(np.float32)).to(
                device) for _ in range(2))
        got = sfx.infer_exported(loaded, left, right)
        with torch.no_grad():
            want = sfx.make_infer_fn(model, opt.iters)(left, right)
        err = float((got - want).abs().max())
        if got.shape != want.shape or not err < CHECK_TOL_PX:
            raise RuntimeError(
                f"the artifact does not compute the model: shape "
                f"{tuple(got.shape)} against {tuple(want.shape)}, largest "
                f"difference {err} px")
        record["check_max_err_px"] = err

    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
