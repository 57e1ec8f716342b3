"""What a resumed training run needs on the card to end bit-equal to an
uninterrupted one.

    python3 -m stereoformer_tpu_torch.scripts.resume_determinism

Under each of four settings, ``python -m stereoformer_tpu_torch.cli.train``'s
main runs the resume protocol (``TRAINER_ARGS``: ``LowCNN_gru`` at 320x640,
B=4, 12 iterations, the loss-schedule file; here on ``dummy:16``, 4 steps
an epoch): 2 epochs, then ``--resume`` to 3, and 3 epochs straight in
another directory; the resumed state is compared with the uninterrupted
one (``train.state_diffs``: the largest and the norm-wise relative
difference of the parameters and BatchNorm buffers, and of each AMSGrad
moment). ``chip_smoke.py``'s phase 14 runs the same protocol on
``dummy:32`` under the last setting. The settings: PyTorch's defaults
(cuDNN picks its algorithms by heuristics and may pick nondeterministic
ones); cuDNN benchmarking on (it times the candidates and keeps the
fastest); cuDNN deterministic with benchmarking off; and that with
``torch.use_deterministic_algorithms(True, warn_only=True)``, whose
warnings name every op on the path that has no deterministic kernel.
Prints one JSON line per setting, with the ms/step of the uninterrupted
run's last epoch (host clock, 4 steps; the first waits for the loader to
fill). Needs the card; run it from the repo's root (the loss-schedule
file's path is relative to it).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import warnings

# cuBLAS reads its workspace setting once, at its first use
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

TRAINER_ARGS = ["--dataset", "dummy:32", "--net", "LowCNN_gru",
                "--batch_size", "4", "--test_batch", "4",
                "--crop_h", "320", "--crop_w", "640",
                "--train_iters", "12", "--eval_iters", "12",
                "--loss", "config/loss_config_disp.json", "--workers", "4",
                "--device", "cuda"]


def train_run(args: list, root: str, out: str, *extra: str):
    """``cli.train``'s main on ``args`` into ``root/out`` (TensorBoard logs
    in ``root/logs``); returns its trainer."""
    from stereoformer_tpu_torch.cli.train import main as train_main

    return train_main(list(args) + [
        "--outf", os.path.join(root, out),
        "--save_logdir", os.path.join(root, "logs")] + list(extra))


def main() -> int:
    import torch

    from stereoformer_tpu_torch.train import state_diffs

    args = list(TRAINER_ARGS)
    args[args.index("dummy:32")] = "dummy:16"
    settings = {"default": (False, False, False),
                "benchmark": (False, True, False),
                "cudnn": (True, False, False),
                "cudnn+torch": (True, False, True)}
    for name, (deterministic, benchmark, algorithms) in settings.items():
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
        torch.use_deterministic_algorithms(algorithms, warn_only=True)
        tmp = tempfile.mkdtemp(prefix="resume_determinism_")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                train_run(args, tmp, "split", "--epochs", "2")
                resumed = train_run(args, tmp, "split", "--epochs", "3",
                                    "--resume")
                whole = train_run(args, tmp, "whole", "--epochs", "3")
            ops = sorted({str(w.message).splitlines()[0] for w in caught
                          if "deterministic" in str(w.message)})
            diffs = state_diffs(resumed.state, whole.state)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({
            "setting": name, "cudnn_deterministic": deterministic,
            "cudnn_benchmark": benchmark,
            "deterministic_algorithms": algorithms,
            "steps": whole.state.step, "diffs": diffs,
            "last_epoch_ms_per_step": 1e3 * whole.history[-1]["seconds"]
            / whole.history[-1]["steps"],
            "bit_equal": all(d["max_abs"] == 0.0 for d in diffs.values()),
            "ops_without_deterministic_kernel": ops,
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
