"""Time the deformable conv's GPU route at the learned bounds' shapes, for
checkouts side by side.

    python3 stereoformer_tpu_torch/scripts/time_deform_sample.py [ROOT ...]

For each ROOT (a checkout of this repository; default: the one holding this
file), in a process of its own that imports that checkout's port:
``ops.deform_conv_fused`` (whatever that checkout launches for it: the
fused kernel, or a matmul and a sampling kernel) at the shapes of
``LowCNN_dynamic`` (eval, B=8 at 576x960, and train, B=4 at 320x640: x
[B, H/8, W/8, 16] -> 16 channels, 3x3 taps, window 2) and of
``ResSubmoduleAttention(deform=True)``'s bottleneck (B=8, x [8, 36, 60,
256] -> 256 channels at 1/16 of 576x960), with the inputs of
the ``chip_smoke.py`` beside this file (``deform_inputs``, seed 0) and its
timing (``graph_ms``, CUDA-graph replay); where the checkout has the
fused kernel (``deform_sample_launch``), also the tiling its C entry picks
and the kernel under every tile height (1 to 8 rows) and both warp widths
(32 and 16 pixels, ``mt`` 2 and 1) with the taps in one slice, and under
the picked tile with the taps in 2 and 3 slices (null where the C entry
refuses the tiling); the same call on offsets
that vary smoothly over the image; and the backward at the train shape
(autograd of the plain windowed form): its kernels' device time a call by
the profiler, and its time a call by CUDA events over back-to-back calls,
host gaps included, in five runs. Prints the card's name and power limit,
then one JSON line per root with the registers and spills of its kernel. To compare two
versions on one card, give their roots as parent, change, change, parent.
Run it by path, not with ``-m``, so that each process imports the checkout
it is given.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"
SHAPES = {"eval": (8, 72, 120, 16, 16), "train": (4, 40, 80, 16, 16),
          "res_attention": (8, 36, 60, 256, 256)}


def time_root(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from stereoformer_tpu_torch import kernels, ops
    from stereoformer_tpu_torch.ops import deform

    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    rng = np.random.default_rng(0)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    for where, shape in SHAPES.items():
        x, off, mask, w = smoke.deform_inputs(rng, shape, 1.8)
        out[f"{where} {list(shape)}"] = smoke.graph_ms(
            lambda: ops.deform_conv_fused(x, off, mask, w), 50)
        if hasattr(deform, "deform_sample_launch"):
            plan = {}
            deform.deform_sample_launch(x, off, mask, w, plan=plan)
            out[f"{where} plan"] = plan
            tilings = [(mt, rows, 1) for mt in (2, 1) for rows in range(1, 9)]
            tilings += [(plan["mt"], plan["rows"], ts) for ts in (2, 3)]
            for mt, rows, ts in tilings:
                forced = dict(rows=rows, mt=mt, ts=ts, halo=plan["halo"])
                try:
                    ms = smoke.graph_ms(
                        lambda forced=forced: deform.deform_sample_launch(
                            x, off, mask, w, plan=forced), 50)
                except RuntimeError:   # a tiling the C entry refuses
                    torch.cuda.synchronize()
                    ms = None
                out[f"{where} mt={mt} rows={rows} ts={ts}"] = ms
        # offsets that vary smoothly over the image, as a trained offset
        # conv gives them, in the same +-1.8 px: neighbouring pixels sample
        # neighbouring corners
        B, H, W, _, _ = shape
        yy, xx = torch.meshgrid(torch.arange(H, device=x.device),
                                torch.arange(W, device=x.device),
                                indexing="ij")
        phase = (0.21 * yy + 0.13 * xx)[None, :, :, None] + torch.arange(
            9, device=x.device)
        smooth = 1.8 * torch.stack([torch.sin(phase), torch.cos(phase)],
                                   -1).expand(B, H, W, 9, 2).contiguous()
        out[f"{where} smooth offsets"] = smoke.graph_ms(
            lambda: ops.deform_conv_fused(x, smooth, mask, w), 50)
        if where == "train":
            leaves = [t.clone().requires_grad_(True) for t in (x, off, mask,
                                                               w)]
            y = ops.deform_conv_fused(*leaves)
            g = smoke.randn(rng, *y.shape)

            def bwd():
                return torch.autograd.grad(y, leaves, g, retain_graph=True)

            out["train backward (profiler, device)"] = smoke.profiler_ms(
                bwd, 5, "")
            out["train backward (events, 5 runs)"] = [
                smoke.time_ms(bwd, 4) for _ in range(5)]
    out["ptxas"] = kernels.ptxas_usage("deform_sample")
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
