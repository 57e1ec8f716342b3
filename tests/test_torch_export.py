"""The port's export (``stereoformer_tpu_torch/export.py``) on the CPU: every
registry name as a ``torch.export`` artifact.

Each name is built at 32x64 with the registry's seeded weights, exported
with a symbolic batch and ``ITERS`` GRU iterations, saved, loaded and run
at B=1 and B=3 against the port's live model: the artifact replays the
model's own ops, so it is expected to be bit-equal (held to 1e-5 px): it
dispatches the same aten ops as the live forward, as many times (no copy
added), apart from checks of its inputs' metadata. Its graph calls the
kernels' ``stereoformer::`` ops, each as many times as the live forward
launches the kernel on the card. The bf16 models are in
``test_torch_export_bf16.py``; the artifact without model code, the CLI
and JAX's models in ``test_torch_export_cli.py``.
"""

import collections
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from stereoformer_tpu_torch import export as sfx  # noqa: E402
from stereoformer_tpu_torch.models import (  # noqa: E402
    available_models,
    get_model,
)

H, W, ITERS = 32, 64, 2
# the artifact against the live model: bit-equal is expected
TOL_PX = 1e-5
# the stereoformer:: ops a forward calls at ITERS iterations, by name: as
# many calls as the card's forward launches each kernel
OP_CALLS = {
    "LowCNN": {"corr_band": 1, "local_soft_argmin": 1},
    "LowCNN_simple": {"corr_band": 1},
    "LowCNN_ada": {"corr_band": 1, "local_soft_argmin": 1},
    "LowCNN_gru": {"corr_band": 1, "local_soft_argmin": ITERS},
    "LowCNN_gru2": {"corr_band": 1, "local_soft_argmin": ITERS},
    "LowCNN_dynamic": {"corr_band": 1, "local_soft_argmin": 1,
                       "deform_sample": 1},
    "LowCNN_dynamic_supervised": {"corr_band": 1, "local_soft_argmin": 1,
                                  "deform_sample": 1},
    "RAFT_Stereo": {"conv2d_fused": 14},
    "CrossAttentionStereo": {"local_soft_argmin": ITERS},
}


def op_calls(exported) -> dict:
    """The stereoformer:: ops the artifact's graph calls: name -> calls."""
    calls = {}
    for node in exported.graph.nodes:
        if node.op == "call_function" and isinstance(
                node.target, torch._ops.OpOverload):
            namespace, name = node.target.name().split("::")
            if namespace == "stereoformer":
                calls[name] = calls.get(name, 0) + 1
    return calls


# not counted: the artifact's checks of its inputs' metadata and sizes,
# and the constants a forward makes from Python values (torch.tensor(...)
# in the live model, a kept constant copied in the artifact)
BOOKKEEPING = {"aten._assert_tensor_metadata.default", "aten.sym_size.int",
               "aten.lift_fresh.default", "aten.lift_fresh_copy.default"}


class OpCounts(TorchDispatchMode):
    """The aten ops a run dispatches, by name, but for those that return
    their input as it is (a conversion to the dtype it has): no work."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if name not in BOOKKEEPING and not (args and out is args[0]):
            self.counts[name] += 1
        return out


def round_trip(model, path, want_calls):
    exported = sfx.export_model(model, H, W, iters=ITERS)
    nbytes = sfx.save_exported(exported, path)
    assert nbytes == os.path.getsize(path) > 0
    loaded = sfx.load_exported(path)
    os.remove(path)   # the weights: tens of MB
    assert op_calls(loaded) == want_calls
    rng = np.random.default_rng(0)
    for B in (1, 3):
        left, right = (torch.from_numpy(
            rng.standard_normal((B, H, W, 3)).astype(np.float32))
            for _ in range(2))
        with OpCounts() as ran:
            got = sfx.infer_exported(loaded, left, right)
        with OpCounts() as live, torch.inference_mode():
            want = sfx.make_infer_fn(model, ITERS)(left, right)
        # the same ops as the live forward, as many times: no copies added
        assert ran.counts == live.counts
        assert got.shape == want.shape == (B, H, W, 1)
        assert got.dtype == torch.float32
        err = (got - want).abs().max().item()
        assert err <= TOL_PX, (B, err)


def test_every_registry_name_has_a_call_count():
    assert sorted(OP_CALLS) == available_models()


@pytest.mark.parametrize("name", sorted(OP_CALLS))
def test_export_round_trip_matches_the_live_model(name, tmp_path):
    model = get_model(name, device="cpu")
    round_trip(model, str(tmp_path / f"{name}.pt2"), OP_CALLS[name])


def test_concrete_batch_export(tmp_path):
    """``batch=3`` exports a fixed batch: the artifact takes B=3 only."""
    model = get_model("LowCNN_gru", device="cpu")
    exported = sfx.export_model(model, H, W, iters=ITERS, batch=3)
    rng = np.random.default_rng(1)
    left, right = (torch.from_numpy(
        rng.standard_normal((3, H, W, 3)).astype(np.float32))
        for _ in range(2))
    got = sfx.infer_exported(exported, left, right)
    with torch.no_grad():
        want = model(left, right, iters=ITERS)["disparities"][-1]
    assert (got - want).abs().max().item() <= TOL_PX
    with pytest.raises((AssertionError, RuntimeError)):
        sfx.infer_exported(exported, left[:2], right[:2])
