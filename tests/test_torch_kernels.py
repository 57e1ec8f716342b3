"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for the card and
skips with a reason where there is none. Run them on the card with
``python -m pytest --noconftest tests/test_torch_kernels.py`` (the suite's
conftest sets up JAX, which the card's machine need not have).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from stereoformer_tpu_torch import ops  # noqa: E402

pytestmark = pytest.mark.cuda

# float32 dot products over C in another order than the plain version's
CORR_TOL = 1e-5
# disparities up to ~26 px; exp and division in another order
LOCAL_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _randn(rng, shape, device):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)


def _edge_candidates(rng, shape, device):
    cands = rng.uniform(-2, 26, shape).astype(np.float32)
    special = np.array([0.0, 23.0, 5.0, 4.5, 6.0, -1.0, 24.0, 11.0],
                       np.float32)
    pick = rng.random(shape) < 0.3
    cands[pick] = rng.choice(special, size=int(pick.sum()))
    return torch.from_numpy(cands).to(device)


@pytest.mark.parametrize("shape", [(2, 8, 120, 256), (1, 3, 10, 40),
                                   (1, 2, 97, 36), (1, 2, 300, 64)],
                         ids=["main-width", "W<D", "ragged-W-C", "W>tile"])
def test_corr_band_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(0)
    left = _randn(rng, shape, cuda_device)
    right = _randn(rng, shape, cuda_device)
    got = ops.correlation_volume(left, right, 24)
    want = ops.correlation_volume_plain(left, right, 24)
    torch.cuda.synchronize()
    assert got.shape == shape[:3] + (24,)
    torch.testing.assert_close(got, want, rtol=0, atol=CORR_TOL)


@pytest.mark.parametrize("shape", [(2, 72, 120), (1, 7, 19)],
                         ids=["main-width", "ragged-N"])
def test_local_soft_argmin_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(1)
    vol = _randn(rng, shape + (24,), cuda_device)
    cands = _edge_candidates(rng, shape + (21,), cuda_device)
    got = ops.local_soft_argmin(vol, cands)
    want = ops.local_soft_argmin_plain(vol, cands)
    torch.cuda.synchronize()
    assert got.shape == shape + (1,)
    torch.testing.assert_close(got, want, rtol=0, atol=LOCAL_TOL)


def test_wrappers_count_launches(cuda_device):
    rng = np.random.default_rng(2)
    feat = _randn(rng, (1, 4, 40, 32), cuda_device)
    n_corr = ops.correlation_volume.launches
    n_local = ops.local_soft_argmin.launches
    vol = ops.correlation_volume(feat, feat, 24)
    ops.local_soft_argmin(vol, _edge_candidates(rng, (1, 4, 40, 21),
                                                cuda_device))
    assert ops.correlation_volume.launches == n_corr + 1
    assert ops.local_soft_argmin.launches == n_local + 1


def test_cuda_backward_raises(cuda_device):
    rng = np.random.default_rng(3)
    left = _randn(rng, (1, 2, 30, 16), cuda_device).requires_grad_(True)
    vol = ops.correlation_volume(left, left.detach(), 24)
    with pytest.raises(NotImplementedError, match="training slice"):
        vol.sum().backward()
    vol = _randn(rng, (1, 2, 30, 24), cuda_device).requires_grad_(True)
    disp = ops.local_soft_argmin(
        vol, _edge_candidates(rng, (1, 2, 30, 21), cuda_device))
    with pytest.raises(NotImplementedError, match="training slice"):
        disp.sum().backward()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    rng = np.random.default_rng(4)
    feat = _randn(rng, (1, 2, 30, 16), cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ops.correlation_volume(feat.double(), feat.double(), 24)
    with pytest.raises(ValueError, match="contiguous"):
        ops.correlation_volume(feat.transpose(1, 2), feat.transpose(1, 2), 24)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.correlation_volume(feat, feat.cpu(), 24)
    odd = _randn(rng, (1, 2, 30, 18), cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.correlation_volume(odd, odd, 24)
    with pytest.raises(ValueError, match="max_disp <= 64"):
        ops.correlation_volume(feat, feat, 65)
    flat = _randn(rng, (2 * 30 * 16 + 1,), cuda_device)
    shifted = flat[1:].view(1, 2, 30, 16)     # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.correlation_volume(shifted, shifted, 24)
    vol = _randn(rng, (1, 2, 30, 24), cuda_device)
    with pytest.raises(ValueError, match="S <= 32"):
        ops.local_soft_argmin(vol, _randn(rng, (1, 2, 30, 40), cuda_device))
