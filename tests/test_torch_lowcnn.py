"""The PyTorch port's LowCNN_gru against the JAX model, on the CPU.

The JAX variables are overwritten leaf by leaf with seeded numpy values
(BatchNorm scale and variance drawn in [0.5, 1.5], means and shifts
nonzero, so a swapped or misplaced BatchNorm mapping shows), passed to the
port through ``weights.lowcnn_state_dict_from_jax``, and both models run the
same seeded inputs. Also: the weight bridge's round trip through the JAX
package's converter, checkpoint loading, the registry, the inference CLI,
and that the port imports nothing of JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

torch.set_num_threads(1)

from stereoformer_tpu.models.low_cnn import LowCNN as JaxLowCNN  # noqa: E402
from stereoformer_tpu.train.torch_import import (  # noqa: E402
    convert_lowcnn_state_dict,
)
from stereoformer_tpu_torch.models import LowCNN, get_model  # noqa: E402
from stereoformer_tpu_torch.weights import (  # noqa: E402
    load_state_dict_file,
    lowcnn_state_dict_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 2
# f32 on both sides, summed in different orders through ~20 convs and two
# GRU steps; 1e-3 px is the stated bound
TOL_PX = 1e-3


def _seeded_variables(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(node, name=""):
        if hasattr(node, "items"):
            return {k: fill(v, k) for k, v in node.items()}
        shape = node.shape
        if name == "kernel":
            # between LeCun and He scale: the volume's softmax is neither
            # flat (LeCun) nor nearly one-hot (He)
            std = np.sqrt(1.25 / np.prod(shape[:-1]))
            return (std * rng.standard_normal(shape)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return fill(shapes)


@pytest.fixture(scope="module")
def jax_run():
    """Seeded variables, inputs, and the JAX model's eval outputs at 64x256
    (W/8 = 32 > D = 24), B=2, two GRU iterations."""
    rng = np.random.default_rng(0)
    left = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    right = rng.standard_normal((2, 64, 256, 3)).astype(np.float32)
    model = JaxLowCNN(refinement="gru")
    shapes = jax.eval_shape(
        lambda a, b: model.init(jax.random.PRNGKey(0), a, b, iters=1,
                                train=False), left, right)
    variables = _seeded_variables(shapes, seed=1)
    out = jax.jit(lambda v, a, b: model.apply(v, a, b, iters=ITERS,
                                              train=False))(
        variables, left, right)
    out = jax.tree_util.tree_map(np.asarray, out)
    return variables, left, right, out


def test_lowcnn_gru_eval_matches_jax(jax_run):
    variables, left, right, want = jax_run
    model = LowCNN().eval()
    model.load_state_dict(lowcnn_state_dict_from_jax(variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(left), torch.from_numpy(right),
                    iters=ITERS)
    assert got["disp_low"].shape == want["disp_low"].shape
    np.testing.assert_allclose(got["disp_low"].numpy(), want["disp_low"],
                               rtol=0, atol=TOL_PX)
    assert len(got["disparities"]) == len(want["disparities"]) == ITERS
    for g, w in zip(got["disparities"], want["disparities"]):
        assert g.shape == w.shape == (2, 64, 256, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL_PX)


def test_weight_bridge_round_trip(jax_run):
    variables = jax_run[0]
    sd = lowcnn_state_dict_from_jax(variables)
    back = convert_lowcnn_state_dict(sd, refinement="gru", strict=True)
    flat_want = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf)
    # the port's own module takes the bridged keys exactly
    LowCNN().load_state_dict(sd, strict=True)


def test_reference_checkpoint_file_loads(tmp_path, jax_run):
    """A reference-style file: wrapped in {"state_dict"}, DataParallel
    prefixes, and the GRU's duplicate Sequential alias keys."""
    sd = lowcnn_state_dict_from_jax(jax_run[0])
    ref = {"module." + k: v for k, v in sd.items()}
    for alias, src in (("conv_zz", "conv_z"), ("conv_bb", "conv_b"),
                       ("conv_gg", "conv_g")):
        for leaf in ("weight", "bias"):
            ref[f"module.local_cost_volume.gru.{alias}.0.{leaf}"] = \
                sd[f"local_cost_volume.gru.{src}.{leaf}"]
    path = tmp_path / "ref.pth"
    torch.save({"state_dict": ref}, path)
    loaded = load_state_dict_file(str(path))
    assert sorted(loaded) == sorted(sd)
    model = LowCNN()
    model.load_state_dict(loaded, strict=True)
    np.testing.assert_array_equal(
        model.state_dict()["local_cost_volume.gru.conv_b.weight"].numpy(),
        sd["local_cost_volume.gru.conv_b.weight"].numpy())


def test_infer_cli_on_cpu(tmp_path, jax_run):
    from PIL import Image

    from stereoformer_tpu_torch.cli.infer import main

    rng = np.random.default_rng(5)
    paths = []
    for side in ("left", "right"):
        img = rng.integers(0, 256, (60, 124, 3), dtype=np.uint8)
        paths.append(tmp_path / f"{side}.png")
        Image.fromarray(img).save(paths[-1])
    weights = tmp_path / "w.pth"
    torch.save(lowcnn_state_dict_from_jax(jax_run[0]), weights)
    out = tmp_path / "disp.npy"
    disp = main(["--left", str(paths[0]), "--right", str(paths[1]),
                 "--out", str(out), "--iters", "1", "--device", "cpu",
                 "--weights", str(weights)])
    assert disp.shape == (60, 124)
    assert np.isfinite(disp).all()
    np.testing.assert_array_equal(np.load(out), disp)


def test_get_model_default_device_is_the_gpu():
    """device=None asks for the GPU: it raises where there is none."""
    if torch.cuda.is_available():
        model = get_model("LowCNN_gru", device=None)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model("LowCNN_gru", device=None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model("LowCNN_gru")


def test_get_model_unported_name_raises():
    """A name neither registry has raises, listing the available names."""
    with pytest.raises(ValueError, match="unknown model.*LowCNN_gru"):
        get_model("PSMNet", device="cpu")


def test_get_model_seeded_weights_repeat():
    a = get_model("LowCNN_gru", device="cpu").state_dict()
    b = get_model("LowCNN_gru", device="cpu").state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


_IMPORT_CHECK = r"""
import importlib, importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "stereoformer_tpu")

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

for name in list(sys.modules):
    if blocked(name):
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Block())
for mod in ("stereoformer_tpu_torch", "stereoformer_tpu_torch.ops",
            "stereoformer_tpu_torch.nn", "stereoformer_tpu_torch.models",
            "stereoformer_tpu_torch.data", "stereoformer_tpu_torch.weights",
            "stereoformer_tpu_torch.kernels", "stereoformer_tpu_torch.device",
            "stereoformer_tpu_torch.cli.infer", "stereoformer_tpu_torch.losses",
            "stereoformer_tpu_torch.metrics", "stereoformer_tpu_torch.train",
            "stereoformer_tpu_torch.train.optim",
            "stereoformer_tpu_torch.train.schedule",
            "stereoformer_tpu_torch.train.state",
            "stereoformer_tpu_torch.train.steps",
            "stereoformer_tpu_torch.nn.norm",
            "stereoformer_tpu_torch.ops.corr1d",
            "stereoformer_tpu_torch.ops.deform",
            "stereoformer_tpu_torch.ops.dw_conv",
            "stereoformer_tpu_torch.ops.fused_conv",
            "stereoformer_tpu_torch.ops.gather",
            "stereoformer_tpu_torch.scripts.gather_probe",
            "stereoformer_tpu_torch.ops.upsample",
            "stereoformer_tpu_torch.nn.blocks",
            "stereoformer_tpu_torch.nn.raft",
            "stereoformer_tpu_torch.nn.raft.encoders",
            "stereoformer_tpu_torch.nn.raft.update",
            "stereoformer_tpu_torch.models.raft_stereo",
            "stereoformer_tpu_torch.models.registry",
            "stereoformer_tpu_torch.data.file_io",
            "stereoformer_tpu_torch.data.native",
            "stereoformer_tpu_torch.data.transforms",
            "stereoformer_tpu_torch.data.cache",
            "stereoformer_tpu_torch.data.dataset",
            "stereoformer_tpu_torch.data.loader",
            "stereoformer_tpu_torch.utils",
            "stereoformer_tpu_torch.utils.common",
            "stereoformer_tpu_torch.utils.viz",
            "stereoformer_tpu_torch.train.params",
            "stereoformer_tpu_torch.train.checkpoint",
            "stereoformer_tpu_torch.train.trainer",
            "stereoformer_tpu_torch.parallel",
            "stereoformer_tpu_torch.parallel.distributed",
            "stereoformer_tpu_torch.parallel.fsdp",
            "stereoformer_tpu_torch.cli.train",
            "stereoformer_tpu_torch.cli.evaluate",
            "stereoformer_tpu_torch.cli.analysis",
            "stereoformer_tpu_torch.cli.gen_filelist",
            "stereoformer_tpu_torch.models.cross_attention",
            "stereoformer_tpu_torch.ops.attention",
            "stereoformer_tpu_torch.ops.cost_volume",
            "stereoformer_tpu_torch.ops.deform_roi",
            "stereoformer_tpu_torch.ops.pad",
            "stereoformer_tpu_torch.ops.softargmin",
            "stereoformer_tpu_torch.ops.warp",
            "stereoformer_tpu_torch.nn.aggregation",
            "stereoformer_tpu_torch.nn.conv",
            "stereoformer_tpu_torch.nn.deform",
            "stereoformer_tpu_torch.nn.gru",
            "stereoformer_tpu_torch.nn.residual",
            "stereoformer_tpu_torch.export",
            "stereoformer_tpu_torch.cli.export"):
    importlib.import_module(mod)
left = sorted(m for m in sys.modules if blocked(m))
assert not left, left
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
