"""The port's training CLI (``stereoformer_tpu_torch.cli.train``) on the
CPU: the counterparts of the JAX CLI's end-to-end and resume tests
(``tests/test_cli.py``) with ``--device cpu``, the loss-schedule file, the
flags that are not ported (they raise), and the GPU default (it raises
where there is no GPU)."""

import glob
import json
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from stereoformer_tpu_torch.cli.train import main  # noqa: E402
from stereoformer_tpu_torch.train import checkpoint_meta  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--dataset", "dummy", "--net", "LowCNN_gru",
        "--batch_size", "2", "--test_batch", "2",
        "--crop_h", "32", "--crop_w", "64",
        "--train_iters", "1", "--eval_iters", "1", "--workers", "0"]


@pytest.fixture(autouse=True)
def _remove_checkpoints(tmp_path):
    """A LowCNN_gru checkpoint is a 290 MB file: remove this test's files
    when it ends, not when pytest next prunes its old directories."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _args(tmp_path, name="models", device="cpu"):
    return ARGS + ["--outf", str(tmp_path / name),
                   "--save_logdir", str(tmp_path / "logs"),
                   "--device", device]


def _ckpts(outf):
    return sorted(glob.glob(os.path.join(outf, "LowCNN_gru_0_*")))


def test_cli_dummy_end_to_end(tmp_path):
    outf = str(tmp_path / "models")
    trainer = main(_args(tmp_path) + ["--epochs", "2", "--train_iters", "2",
                                      "--eval_iters", "2", "--no_mesh",
                                      "--use_deform", "--scan_unroll", "2"])
    ckpts = _ckpts(outf)
    assert len(ckpts) == 2, ckpts
    assert [checkpoint_meta(p)["epoch"] for p in ckpts] == [0, 1]
    assert os.path.isfile(os.path.join(outf, "model_best"))
    assert os.path.isfile(os.path.join(outf, "train.log"))
    assert trainer.state.step == 8 and trainer.device.type == "cpu"
    assert trainer.train_iters == 2
    # no temporary file is left behind
    assert sorted(os.listdir(outf)) == sorted(
        [os.path.basename(p) for p in ckpts] + ["model_best", "train.log"])


def test_cli_resume_trains_only_the_missing_epoch(tmp_path):
    """--resume picks up the latest checkpoint, trains epoch 1 only, and
    ends where an uninterrupted 2-epoch run ends, bit for bit."""
    outf = str(tmp_path / "models")
    main(_args(tmp_path) + ["--epochs", "1"])
    first = set(_ckpts(outf))
    assert len(first) == 1
    resumed = main(_args(tmp_path) + ["--epochs", "2", "--resume"])
    new = set(_ckpts(outf)) - first
    assert len(new) == 1 and "_0_1_" in list(new)[0]
    assert resumed.is_pretrain and resumed.state.step == 8
    whole = main(_args(tmp_path, "whole") + ["--epochs", "2"])
    a, b = resumed.state, whole.state
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert a.opt_state.count == b.opt_state.count == 8
    for m in ("mu", "nu", "nu_max"):
        for k, v in getattr(a.opt_state, m).items():
            assert torch.equal(v, getattr(b.opt_state, m)[k]), (m, k)


def test_cli_reads_the_loss_schedule(tmp_path):
    path = os.path.join(REPO, "config", "loss_config_disp.json")
    with open(path) as f:
        scheme = json.load(f)
    trainer = main(_args(tmp_path) + ["--loss", path, "--epochs", "1",
                                      "--loss_name", "sequence"])
    assert trainer.loss_weights == tuple(scheme["loss_weights"][0])
    assert trainer.loss_name == "sequence"
    assert len(_ckpts(str(tmp_path / "models"))) == scheme["round"]
    with open(tmp_path / "models" / "train.log") as f:
        assert f"weights {scheme['loss_weights'][0]}" in f.read()


def test_cli_profile_dir_writes_a_trace(tmp_path):
    main(_args(tmp_path) + ["--epochs", "1", "--profile_dir",
                            str(tmp_path / "prof")])
    traces = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("flags", [["--fsdp"], ["--dtype", "bf16"],
                                   ["--gru_loop", "scan"]])
def test_cli_unported_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="not ported"):
        main(_args(tmp_path) + ["--epochs", "1"] + flags)
    assert not os.path.exists(tmp_path / "models")


def test_cli_devices_takes_one_index(tmp_path):
    with pytest.raises(ValueError, match="one index"):
        main(_args(tmp_path, device="cuda") + ["--devices", "0,1"])


def test_cli_without_a_gpu_raises_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    for device in ("cuda", "cuda:0"):
        args = _args(tmp_path)
        args[args.index("--device") + 1] = device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args + ["--epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([a for a in _args(tmp_path) if a not in ("--device", "cpu")]
             + ["--epochs", "1"])
    assert not os.path.exists(tmp_path / "models")
