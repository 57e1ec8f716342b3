"""The port's row gather (``ops.take_rows``) and its probe script, on the
CPU.

The Pallas probe (``scripts/_gather_probe.py``) runs only on a TPU, so the
port is held against numpy's ``take_along_axis``, bit for bit; the CUDA
kernel ``csrc/row_gather.cu`` is held against the plain version on the card
in ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stereoformer_tpu_torch import ops  # noqa: E402
from stereoformer_tpu_torch.scripts import gather_probe  # noqa: E402


@pytest.mark.parametrize("m", [8640, 100, 0], ids=["square", "fewer-rows",
                                                    "empty"])
def test_take_rows_matches_numpy(m):
    rng = np.random.default_rng(0)
    img = rng.standard_normal((8640, 64)).astype(np.float32)
    idx = rng.integers(0, 8640, (m, 64)).astype(np.int32)
    got = ops.take_rows(torch.from_numpy(img), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(img, idx, axis=0))


def test_take_rows_refuses_what_it_cannot_gather():
    img = torch.zeros((10, 4))
    for bad in (10, -1):
        idx = torch.zeros((3, 4), dtype=torch.int32)
        idx[1, 2] = bad
        with pytest.raises(IndexError, match="in \\[0, 10\\)"):
            ops.take_rows(img, idx)
    with pytest.raises(TypeError, match="integer"):
        ops.take_rows(img, torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="\\[M, C\\]"):
        ops.take_rows(img, torch.zeros((3, 5), dtype=torch.int32))


def test_gather_probe_on_the_cpu(capsys):
    out = gather_probe.main(["--device", "cpu"])
    assert out.shape == (8640, 64) and out.device.type == "cpu"
    assert capsys.readouterr().out.startswith("GATHER_PROBE_OK (8640, 64) cpu")
    # the probe's draw: RandomState(0), the JAX script's
    rng = np.random.RandomState(0)
    img = rng.randn(8640, 64).astype(np.float32)
    rows = rng.randint(0, 8640, size=(8640, 1))
    np.testing.assert_array_equal(out.numpy(), img[rows[:, 0]])


def test_gather_probe_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("covered on the card by tests/test_torch_kernels.py")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather_probe.main([])
