"""Time the refinement kernels at LowCNN's shapes, for checkouts side by side.

    python3 stereoformer_tpu_torch/scripts/time_refine_kernels.py [ROOT ...]

For each ROOT (a checkout of this repository; default: the one holding this
file), in a process of its own that imports that checkout's port: the
kernels ``corr_band``, ``local_soft_argmin`` and ``local_soft_argmin_bwd``
at the shapes of ``LowCNN_gru`` (eval, B=8 at 576x960; train, B=4 at
320x640: the volume [B, H/8, W/8, D] with D = 24 and S = 21 candidates,
features of C = 256), and at D = 96, S = 33 (``max_disp=768``,
``num_samples=32``), with the inputs of the ``chip_smoke.py`` beside this
file (``randn``, ``edge_candidates``, seed 0) and its timing (``graph_ms``,
CUDA-graph replay). The backward is launched alone, as its autograd node
launches it. A shape that a checkout's wrapper or kernel refuses is timed
as null. Prints the card's name and power limit, then one JSON line per
root with each kernel's registers and spills. To compare two versions on
one card, give their roots as parent, change, change, parent. Run it by
path, not with ``-m``, so that each process imports the checkout it is
given.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"
EVAL, TRAIN, C = (8, 72, 120), (4, 40, 80), 256
# (kernel, volume's [B, H, W], D, S)
CASES = [("corr_band", EVAL, 24, 21), ("corr_band", TRAIN, 24, 21),
         ("corr_band", EVAL, 96, 33),
         ("local_soft_argmin", EVAL, 24, 21),
         ("local_soft_argmin", TRAIN, 24, 21),
         ("local_soft_argmin", EVAL, 96, 33),
         ("local_soft_argmin_bwd", TRAIN, 24, 21),
         ("local_soft_argmin_bwd", EVAL, 24, 21),
         ("local_soft_argmin_bwd", TRAIN, 96, 33)]


def time_root(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from stereoformer_tpu_torch import kernels, ops

    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    for name, shape, D, S in CASES:
        npix = int(np.prod(shape))
        if name == "corr_band":
            left, right = (smoke.randn(rng, *shape, C) for _ in range(2))
            fn = lambda: ops.correlation_volume(left, right, D)  # noqa: E731
        else:
            vol = smoke.randn(rng, *shape, D)
            cands = torch.from_numpy(
                smoke.edge_candidates(rng, shape + (S,), D)).to(dev)
            if name == "local_soft_argmin":
                fn = lambda: ops.local_soft_argmin(vol, cands)  # noqa: E731
            else:
                g = smoke.randn(rng, *shape, 1)
                dvol, dcand = torch.empty_like(vol), torch.empty_like(cands)
                fn = lambda: kernels.launch(  # noqa: E731
                    name, dev, vol.data_ptr(), cands.data_ptr(),
                    g.data_ptr(), dvol.data_ptr(), dcand.data_ptr(), npix,
                    D, S)
        key = f"{name} {list(shape)} D={D} S={S}"
        try:
            out[key] = smoke.graph_ms(fn, 50 if name == "corr_band" else 200)
        except (ValueError, RuntimeError) as exc:   # refused by this root
            out[key] = None
            out[key + " refused"] = str(exc)
    out["ptxas"] = {n: kernels.ptxas_usage(n) for n in
                    ("corr_band", "local_soft_argmin", "local_soft_argmin_bwd")}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps(time_root(argv[1])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for root in argv or [str(SMOKE.parent)]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
