"""The port's evaluation entry points against the JAX CLIs, on the CPU.

One JAX ``LowCNN_gru`` state (seeded weights; seeded, nonzero AMSGrad
moments and counts) is written with the JAX package's ``save_checkpoint``
and bridged into a port checkpoint by ``scripts/jax_ckpt_to_torch.py``;
the JAX CLIs read the JAX checkpoint, the port's the bridged one:
``cli.evaluate`` on ``dummy``, ``cli.infer`` with ``--gt`` and
``--error-out``, and ``cli.analysis``, at 64x128 (or a 60x124 pair,
padded) with 2 GRU iterations. Also: the bridged file is bit-exact (the
whole LowCNN_gru state), the port reads its own trainer's checkpoints
(``cli.infer --ckpt``, ``load_state_dict_file``), and ``cli.gen_filelist``
writes the JAX CLI's list byte for byte.
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

torch.set_num_threads(1)

from test_torch_bridge import CROP, _bridge, _save_jax, _seeded_state  # noqa: E402
from test_torch_lowcnn import TOL_PX  # noqa: E402

from stereoformer_tpu.cli import analysis as jax_analysis  # noqa: E402
from stereoformer_tpu.cli import evaluate as jax_evaluate  # noqa: E402
from stereoformer_tpu.cli import gen_filelist as jax_gen_filelist  # noqa: E402
from stereoformer_tpu.cli import infer as jax_infer  # noqa: E402
from stereoformer_tpu_torch.cli import analysis, evaluate, gen_filelist, infer  # noqa: E402
from stereoformer_tpu_torch.data import DummyStereoDataset, write_pfm  # noqa: E402
from stereoformer_tpu_torch.models import get_model  # noqa: E402
from stereoformer_tpu_torch.train import (  # noqa: E402
    Amsgrad,
    TrainState,
    checkpoint_meta,
    restore_checkpoint,
    save_checkpoint,
)
from stereoformer_tpu_torch.utils import disp_error_image  # noqa: E402
from stereoformer_tpu_torch.weights import (  # noqa: E402
    amsgrad_state_from_jax,
    load_state_dict_file,
    seeded_state_dict,
    state_dict_from_jax,
)

ITERS = ["--iters", "2"]
# the evaluation's averages: float32 on both sides, summed in other orders;
# a pixel within rounding of P1's or D1's threshold may fall either way
EPE_TOL_PX, FRACTION_TOL = 1e-3, 1e-3


def _write_pair(root, h, w):
    """A dummy pair as 8-bit PNGs and its ground truth as PFM."""
    from PIL import Image

    s = DummyStereoDataset(length=1, height=h, width=w, seed=4)[0]
    paths = {}
    for side in ("left", "right"):
        paths[side] = os.path.join(root, f"{side}.png")
        Image.fromarray(np.clip(s[f"img_{side}"], 0, 255).astype(
            np.uint8)).save(paths[side])
    paths["gt"] = os.path.join(root, "gt.pfm")
    write_pfm(paths["gt"], s["gt_disp"])
    return paths


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The JAX LowCNN_gru checkpoint (model_best), its bridged port file,
    the JAX state, and a 60x124 pair; removed when the module ends (each
    checkpoint holds ~290 MB)."""
    root = tmp_path_factory.mktemp("cli_eval")
    state = _seeded_state("LowCNN_gru", seed=1)
    jax_ckpt = _save_jax(root / "jax", "LowCNN_gru", state)
    port_ckpt = _bridge(jax_ckpt, "LowCNN_gru", str(root / "port.pt"))
    pair = _write_pair(str(root), 60, 124)
    yield {"jax": jax_ckpt, "port": port_ckpt, "state": state,
           "pair": pair, "root": root}
    shutil.rmtree(root, ignore_errors=True)


def test_port_reads_its_own_trainer_checkpoint(tmp_path):
    """The trainer's model_best serves: load_state_dict_file unwraps its
    "model", and cli.infer --ckpt (and --weights) give the disparity of the
    model that was saved."""
    model = get_model("LowCNN_gru", device="cpu")
    model.load_state_dict(seeded_state_dict(model, seed=3))
    save_checkpoint(str(tmp_path), TrainState.create(model, Amsgrad(1e-3)),
                    "LowCNN_gru", 0, 0, 1.0, True)
    best = str(tmp_path / "model_best")
    fresh = get_model("LowCNN_gru", device="cpu")
    fresh.load_state_dict(load_state_dict_file(best))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    pair = _write_pair(str(tmp_path), 60, 124)
    args = ["--left", pair["left"], "--right", pair["right"], "--device",
            "cpu"] + ITERS
    by_ckpt = infer.main(args + ["--ckpt", best,
                                 "--out", str(tmp_path / "a.pfm")])
    by_weights = infer.main(args + ["--weights", best,
                                    "--out", str(tmp_path / "b.pfm")])
    seeded = infer.main(args + ["--out", str(tmp_path / "c.pfm")])
    np.testing.assert_array_equal(by_ckpt, by_weights)
    assert np.abs(by_ckpt - seeded).max() > 0.1   # the weights were read
    with pytest.raises(SystemExit):
        infer.main(args + ["--ckpt", best, "--weights", best,
                           "--out", str(tmp_path / "d.pfm")])


def test_bridge_round_trip_is_bit_equal(ckpts):
    """The bridged LowCNN_gru file, read by the port's restore_checkpoint:
    parameters, BatchNorm statistics, count, mu, nu, nu_max, step and meta
    equal to the weights bridge of the same JAX state, bit for bit."""
    state = jax.tree_util.tree_map(np.asarray, ckpts["state"])
    model = get_model("LowCNN_gru", device="cpu")
    got = restore_checkpoint(ckpts["port"], TrainState.create(
        model, Amsgrad(1e-3)))
    want = state_dict_from_jax("LowCNN_gru", {
        "params": state.params, "batch_stats": state.batch_stats})
    assert sorted(got.model.state_dict()) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got.model.state_dict()[k], v), k
    opt = amsgrad_state_from_jax(state.opt_state, model)
    assert got.step == 7 and got.opt_state.count == opt.count == 7
    for m in ("mu", "nu", "nu_max"):
        mine, theirs = getattr(got.opt_state, m), getattr(opt, m)
        assert sorted(mine) == sorted(theirs)
        assert any(v.abs().max() > 0 for v in theirs.values())
        for k, v in theirs.items():
            assert torch.equal(mine[k], v), (m, k)
    assert checkpoint_meta(ckpts["port"]) == {
        "round": 0, "epoch": 3, "arch": "LowCNN_gru", "best_EPE": 1.234,
        "step": 7}


def test_evaluate_matches_jax_cli(ckpts, capsys):
    """cli.evaluate on dummy (8 pairs at 64x128, batches of 4, 2
    iterations): the same JSON keys, EPE within 1e-3 px, P1 and D1 within
    1e-3, the same image count."""
    args = ["--dataset", "dummy", "--test_batch", "4", "--workers", "0"] \
        + CROP + ITERS
    want = jax_evaluate.main(["--ckpt", ckpts["jax"]] + args)
    capsys.readouterr()
    got = evaluate.main(["--ckpt", ckpts["port"], "--device", "cpu"] + args)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert sorted(got) == sorted(want) == sorted(
        ["net", "dataset", "iters", "EPE", "P1", "D1", "s_per_image",
         "images"])
    assert got["images"] == want["images"] == 8
    assert (got["net"], got["dataset"], got["iters"]) == (
        "LowCNN_gru", "dummy", 2)
    assert abs(got["EPE"] - want["EPE"]) <= EPE_TOL_PX, (got, want)
    for k in ("P1", "D1"):
        assert abs(got[k] - want[k]) <= FRACTION_TOL, (k, got, want)
    assert got["s_per_image"] > 0


def test_infer_gt_error_out_matches_jax_cli(ckpts, tmp_path, capsys):
    """cli.infer --ckpt --gt --error-out on a 60x124 pair (padded to
    64x128): the disparity within TOL_PX of the JAX CLI's, the error PNG
    equal to disp_error_image of the port's disparity, and the printed EPE
    that of the port's disparity over gt > 0."""
    from PIL import Image

    from stereoformer_tpu_torch.data import read_disp, read_pfm

    pair = ckpts["pair"]
    args = ["--left", pair["left"], "--right", pair["right"],
            "--gt", pair["gt"]] + ITERS
    want = jax_infer.main(["--ckpt", ckpts["jax"], "--out",
                           str(tmp_path / "jax.pfm"),
                           "--error-out", str(tmp_path / "jax.png")] + args)
    capsys.readouterr()
    got = infer.main(["--ckpt", ckpts["port"], "--device", "cpu", "--out",
                      str(tmp_path / "port.pfm"),
                      "--error-out", str(tmp_path / "port.png")] + args)
    said = capsys.readouterr().out
    assert got.shape == want.shape == (60, 124)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PX)
    written, _ = read_pfm(str(tmp_path / "port.pfm"))
    np.testing.assert_array_equal(written, got)
    gt = read_disp(pair["gt"])
    err = np.asarray(Image.open(str(tmp_path / "port.png")))
    np.testing.assert_array_equal(err, disp_error_image(got, gt))
    assert err.shape == (60, 124, 3)
    epe = float(np.abs(got - gt)[gt > 0].mean())
    assert f"(EPE {epe:.6f})" in said, said


def test_analysis_matches_jax_cli(ckpts, tmp_path, capsys):
    """cli.analysis --ckpt --disp --out: the same .npz keys and shapes,
    the disparities within TOL_PX of the JAX CLI's, the same ground truth,
    and the same printed probe lines up to the last digit."""
    pair = ckpts["pair"]
    args = ["--left", pair["left"], "--right", pair["right"],
            "--disp", pair["gt"], "--pixel", "20", "50"] + ITERS
    jax_analysis.main(["--ckpt", ckpts["jax"],
                       "--out", str(tmp_path / "jax.npz")] + args)
    jax_lines = capsys.readouterr().out.splitlines()
    report = analysis.main(["--ckpt", ckpts["port"], "--device", "cpu",
                            "--out", str(tmp_path / "port.npz")] + args)
    lines = capsys.readouterr().out.splitlines()
    want = np.load(str(tmp_path / "jax.npz"))
    got = np.load(str(tmp_path / "port.npz"))
    assert sorted(got.files) == sorted(want.files) == [
        "disp_final", "disp_low", "gt"]
    assert got["disp_low"].shape == (7, 15)
    assert got["disp_final"].shape == got["gt"].shape == (56, 120)
    for k in ("disp_low", "disp_final"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL_PX)
        np.testing.assert_array_equal(got[k], report[k])
    np.testing.assert_array_equal(got["gt"], want["gt"])
    assert len(lines) == len(jax_lines) == 6
    assert lines[0] == jax_lines[0]        # the probe's 1/8 cell
    assert lines[3] == jax_lines[3]        # its ground truth


@pytest.mark.parametrize("with_disp", [True, False])
def test_gen_filelist_matches_jax_cli(tmp_path, capsys, with_disp):
    """The same list byte for byte, and the same message, over a tree with
    a left image whose right image is missing and one whose disparity is
    missing, in two scenes and a nested directory."""
    root = tmp_path / "data"
    names = ["a/0001.png", "a/0002.png", "a/0003.png", "b/0001.png",
             "b/deep/0007.png"]
    for n in names:
        for side in ("left", "right"):
            if side == "right" and n == "a/0002.png":
                continue
            p = root / side / n
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(b"")
        if n != "b/0001.png":
            p = root / "disp" / n.replace(".png", ".pfm")
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(b"")
    outs = {}
    for label, cli in (("jax", jax_gen_filelist), ("port", gen_filelist)):
        out = tmp_path / f"{label}.list"
        cli.main(["--root", str(root), "--left-dir", "left",
                  "--right-dir", "right", "--out", str(out)]
                 + (["--disp-dir", "disp"] if with_disp else []))
        outs[label] = (out.read_bytes(), capsys.readouterr().out
                       .replace(str(out), "OUT"))
    assert outs["port"] == outs["jax"]
    lines = outs["port"][0].decode().splitlines()
    assert len(lines) == (3 if with_disp else 4)
    assert lines[0] == ("left/a/0001.png right/a/0001.png"
                        + (" disp/a/0001.pfm" if with_disp else ""))
