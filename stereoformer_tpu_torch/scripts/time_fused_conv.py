"""Time the fused stride-1 conv kernel at RAFT's sites, for checkouts side by
side.

    python3 stereoformer_tpu_torch/scripts/time_fused_conv.py [ROOT ...]

For each ROOT (a checkout of this repository; default: the one holding this
file), in a process of its own that imports that checkout's port: the
kernel ``conv2d_fused`` at the eight sites of the ``chip_smoke.py`` beside
this file, with that script's inputs (``conv_inputs``, seed 0) and timing
(``graph_ms``, CUDA-graph replay): the forward at RAFT eval B=2
(``RAFT_CONVS``; the feature net's prologue+stats, the context net's
prologue) and the backward's dx conv at the RAFT train step B=4
(``RAFT_TRAIN_CONVS``; the cotangent with flipped, io-transposed weights
and no bias); then the bf16 form (``conv2d_fused_bf16``) at the four eval
sites, the same entries on the same inputs rounded to bf16, each beside
cuDNN's bf16 ``F.conv2d`` with bias (channels_last) on those inputs.
Every root runs this one protocol, so an older checkout is timed on the
same work. Prints one JSON line per root, with the card's
name. To compare two versions on one card, give their roots as parent,
change, change, parent. Run it by path, not with ``-m``, so that each
process imports the checkout it is given.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"


def time_root(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import torch.nn.functional as F

    from stereoformer_tpu_torch import ops

    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    rng = np.random.default_rng(0)
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    for where, (B, H, W, C) in smoke.RAFT_CONVS.items():
        x, w, b, s, t, r = smoke.conv_inputs(rng, B, H, W, C, C)
        variant = "prologue+stats" if where.startswith("fnet") else "prologue"
        kern, _ = smoke.conv_calls(ops, x, w, b, s, t, r)[variant]
        out[f"fwd {where} {variant}"] = smoke.graph_ms(kern, 10)
        del x, w, b, s, t, r
    for where, (B, H, W, C) in smoke.RAFT_TRAIN_CONVS.items():
        g = smoke.randn(rng, B, H, W, C)
        w = smoke.randn(rng, 3, 3, C, C) / np.sqrt(9 * C)
        w_rot = w.flip((0, 1)).transpose(2, 3).contiguous()
        zero = torch.zeros(C, device="cuda")
        out[f"dx {where}"] = smoke.graph_ms(
            lambda: ops.conv2d_fused(g, w_rot, zero, None, False), 10)
        del g, w, w_rot
    for where, (B, H, W, C) in smoke.RAFT_CONVS.items():
        x, w, b, s, t, r = smoke.conv_inputs(rng, B, H, W, C, C)
        x, w, b, r = (a.bfloat16() for a in (x, w, b, r))
        variant = "prologue+stats" if where.startswith("fnet") else "prologue"
        kern, _ = smoke.conv_calls(ops, x, w, b, s, t, r)[variant]
        out[f"bf16 fwd {where} {variant}"] = smoke.graph_ms(kern, 10)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        out[f"bf16 cudnn {where}"] = smoke.graph_ms(
            lambda: F.conv2d(xc, wc, b, padding=1), 10)
        del x, w, b, s, t, r, xc, wc
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        print(json.dumps(time_root(argv[1])), flush=True)
        return 0
    roots = argv or [str(SMOKE.parent)]
    for root in roots:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
