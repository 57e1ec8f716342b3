"""The port's export entry point on the CPU: ``cli/export.py``, the artifact
in a process without model code, and artifacts made from JAX-initialised
weights against JAX's live model.

- ``python -m stereoformer_tpu_torch.cli.export --device cpu --check``
  with ``--weights`` (a ``state_dict`` bridged from JAX's ``model.init``
  through ``weights.state_dict_from_jax``) for ``LowCNN_gru`` and
  ``RAFT_Stereo``: the JSON line and its keys (JAX's), the check against
  the live model, and the artifact at B=1 and B=3 against JAX's jitted
  ``model.apply`` within 1e-3 px, the other eval tests' tolerance;
- a subprocess that loads and runs an artifact while imports of
  ``stereoformer_tpu_torch.models``, ``.nn`` and ``.train`` are blocked,
  and finds none of them in ``sys.modules`` after the run; its output is
  the live model's;
- ``--loop scan`` raises.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu.models import get_model as jax_get_model  # noqa: E402
from stereoformer_tpu_torch import export as sfx  # noqa: E402
from stereoformer_tpu_torch.cli.export import main  # noqa: E402
from stereoformer_tpu_torch.models import get_model  # noqa: E402
from stereoformer_tpu_torch.weights import state_dict_from_jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, ITERS = 32, 64, 2
# float32 on both sides, summed in other orders (the eval tests' bound)
JAX_TOL_PX = 1e-3
KEYS = {"artifact", "bytes", "net", "resolution", "batch", "iters",
        "platforms", "check_max_err_px"}


def _inputs(B, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, W, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module", params=["LowCNN_gru", "RAFT_Stereo"])
def exported(request, tmp_path_factory):
    """JAX's model and variables (``model.init``), and the CLI's run on
    their bridged weights: (name, JAX model, variables, record, stdout)."""
    name = request.param
    jmodel = jax_get_model(name)
    zeros = np.zeros((1, H, W, 3), np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda a, b: jmodel.init(jax.random.PRNGKey(0), a, b, iters=1,
                                 train=False))(zeros, zeros))
    tmp = tmp_path_factory.mktemp(name)
    weights = str(tmp / "weights.pth")
    torch.save(state_dict_from_jax(name, variables), weights)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        record = main(["--net", name, "--height", str(H), "--width", str(W),
                       "--iters", str(ITERS), "--weights", weights,
                       "--out", str(tmp / "a.pt2"), "--check",
                       "--device", "cpu"])
    return name, jmodel, variables, record, out.getvalue()


def test_cli_record(exported):
    name, _, _, record, stdout = exported
    assert json.loads(stdout.strip().splitlines()[-1]) == record
    assert set(record) == KEYS
    assert record["bytes"] == os.path.getsize(record["artifact"]) > 0
    assert record["net"] == name
    assert record["resolution"] == f"{H}x{W}"
    assert record["batch"] == "symbolic" and record["iters"] == ITERS
    assert record["platforms"] == ["cpu"]
    # the artifact replays the live model's ops: bit-equal
    assert record["check_max_err_px"] == 0.0


def test_artifact_matches_jax(exported):
    _, jmodel, variables, record, _ = exported
    loaded = sfx.load_exported(record["artifact"])
    run = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, iters=ITERS, train=False)["disparities"][-1])
    for B in (1, 3):
        left, right = _inputs(B, seed=B)
        want = np.asarray(run(variables, left, right))
        got = sfx.infer_exported(loaded, torch.from_numpy(left),
                                 torch.from_numpy(right)).numpy()
        assert got.shape == want.shape == (B, H, W, 1)
        err = np.abs(got - want).max()
        assert err < JAX_TOL_PX, (B, err)


_SERVE = r"""
import importlib.abc, sys

import torch

BLOCKED = ("stereoformer_tpu_torch.models", "stereoformer_tpu_torch.nn",
           "stereoformer_tpu_torch.train")


def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("serving imported " + name)
        return None


sys.meta_path.insert(0, Block())
torch.set_num_threads(1)   # the test's threads: the CPU's sums in its order
from stereoformer_tpu_torch import export as sfx

artifact, inputs, output = sys.argv[1:]
left, right = torch.load(inputs)
torch.save(sfx.infer_exported(sfx.load_exported(artifact), left, right),
           output)
found = sorted(m for m in sys.modules if blocked(m))
assert not found, found
print("ok")
"""


def test_artifact_runs_without_model_code(exported, tmp_path):
    name, _, _, record, _ = exported
    left, right = (torch.from_numpy(a) for a in _inputs(2, seed=5))
    inputs, output = str(tmp_path / "in.pt"), str(tmp_path / "out.pt")
    torch.save((left, right), inputs)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", _SERVE, record["artifact"], inputs, output],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
    model = get_model(name, device="cpu")
    model.load_state_dict(torch.load(
        os.path.join(os.path.dirname(record["artifact"]), "weights.pth")))
    with torch.no_grad():
        want = sfx.make_infer_fn(model, ITERS)(left, right)
    assert torch.equal(torch.load(output), want)


def test_cli_loop_scan_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="scan"):
        main(["--net", "LowCNN_gru", "--loop", "scan", "--device", "cpu",
              "--out", str(tmp_path / "a.pt2")])
    assert not os.path.exists(tmp_path / "a.pt2")
