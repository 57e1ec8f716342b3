"""Time the RAFT_Stereo train step on the card, for checkouts side by side,
and beside it RAFT_Stereo's eval and the LowCNN_gru train step.

    python3 stereoformer_tpu_torch/scripts/time_raft_step.py [ROOT ...]

For each ROOT (a checkout of this repository; default: the one holding this
file), in a process of its own that imports that checkout's port: the RAFT
train protocol of the ``chip_smoke.py`` beside this file
(``raft_train_setup``: 320x720, B=4, 12 iterations, sequence loss, AMSGrad
lr 2e-4, one batch from seed 4), with random weights from torch seed 0.
Every root runs this one protocol, so an older checkout is timed on the
same work. One step warms up and builds the kernels; then ms per step by
CUDA events (``chip_smoke.time_ms``) over 6 steps with cuDNN's TF32 on and
over 3 with it off. Then, with TF32 convs, RAFT's eval forward at 576x960,
B=2, 12 iterations, test_mode (ms per batch over 20 forwards) and the
LowCNN_gru train step at 320x640, B=4, 12 iterations, sequence loss,
AMSGrad lr 1e-3 (ms per step over 20 steps): the paths whose host work
is the kernels' dispatch. Prints one JSON line per root. To compare two
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


def time_root(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from stereoformer_tpu_torch import ops

    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    torch.manual_seed(0)
    _, _, state, step, data = smoke.raft_train_setup()
    ops.conv2d_dw.launches = 0
    step(state, data)
    out = {"root": root, "card": torch.cuda.get_device_name(0),
           "conv2d_dw_launches": ops.conv2d_dw.launches}
    for tf32, reps in ((True, 6), (False, 3)):
        torch.backends.cudnn.allow_tf32 = tf32
        key = "tf32_convs_ms" if tf32 else "strict_f32_ms"
        out[key] = smoke.time_ms(lambda: step(state, data), reps, warmup=1)
    torch.backends.cudnn.allow_tf32 = True
    del state, step, data
    out["raft_eval_b2_ms"] = _raft_eval_ms(smoke)
    out["lowcnn_gru_step_b4_ms"] = _lowcnn_step_ms(smoke)
    return out


def _raft_eval_ms(smoke) -> float:
    import torch

    from stereoformer_tpu_torch.models import get_model

    model = get_model("RAFT_Stereo", device="cuda")
    rng = smoke.np.random.default_rng(0)
    left, right = (smoke.randn(rng, 2, smoke.H, smoke.W, 3)
                   for _ in range(2))

    def forward():
        with torch.inference_mode():
            model(left, right, iters=smoke.ITERS, test_mode=True)

    return smoke.time_ms(forward, 20, warmup=2)


def _lowcnn_step_ms(smoke) -> float:
    from stereoformer_tpu_torch.models import get_model
    from stereoformer_tpu_torch.train import (
        Amsgrad,
        TrainState,
        make_train_step,
    )

    tx = Amsgrad(smoke.LR)
    state = TrainState.create(get_model("LowCNN_gru", device="cuda"), tx)
    step = make_train_step(tx, "sequence", iters=smoke.ITERS)
    data = smoke.train_batch(3, 4, smoke.TRAIN_H, smoke.TRAIN_W)
    return smoke.time_ms(lambda: step(state, data), 20, warmup=2)


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
