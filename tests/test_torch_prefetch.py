"""The port's ``DevicePrefetcher`` over epochs of many more batches than
its ``DEPTH``.

The loader collates each batch into fresh page-locked tensors (on the card
machine) and drops them once the prefetcher has queued their copy; the
consumer reads each batch on its stream twice, into a clone made as the
batch is handed out and into one made behind a long matmul, and drops the
batch at once, so the host and device allocators recycle blocks while
later copies are still queued. Every clone must equal an independent host
copy of its batch, bit for bit, in order. The ``cuda`` case runs with
``python -m pytest --noconftest tests/test_torch_prefetch.py`` on the card
and skips with a reason elsewhere; the ``cpu`` case holds order and
content here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from stereoformer_tpu_torch import data  # noqa: E402

# 13 samples of 2: 6 batches, three times DEPTH (the last sample dropped)
N_SAMPLES, BATCH = 13, 2


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device(name)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("workers", [0, 3])
def test_prefetched_batches_equal_host_batches(device, workers):
    device = _device(device)
    ds = data.DummyStereoDataset(length=N_SAMPLES, height=96, width=192,
                                 max_disp=20.0, seed=4)
    loader = data.DataLoader(ds, BATCH, shuffle=True, num_workers=workers,
                             seed=7, pin_memory=device.type == "cuda")
    loader.set_epoch(1)
    host = []

    def tapped():
        for i, b in enumerate(loader):
            host.append({k: torch.as_tensor(v).clone() for k, v in b.items()})
            b["left_name"] = [f"batch{i}"]
            yield b

    busy = torch.randn(1024, 1024, device=device)
    early, late, names = [], [], []
    for dev in data.DevicePrefetcher(tapped(), device):
        names.append(dev.pop("left_name"))
        early.append({k: v.clone() for k, v in dev.items()})
        torch.mm(busy, busy)
        late.append({k: v.clone() for k, v in dev.items()})
        del dev
    if device.type == "cuda":
        torch.cuda.synchronize()
    assert len(host) == N_SAMPLES // BATCH >= 3 * data.DevicePrefetcher.DEPTH
    assert names == [[f"batch{i}"] for i in range(len(host))]
    assert len(early) == len(late) == len(host)
    for i, want in enumerate(host):
        assert sorted(early[i]) == sorted(want)
        for k, v in want.items():
            for got in (early[i][k], late[i][k]):
                assert got.device.type == device.type
                assert torch.equal(got.cpu(), v), (i, k)
    # the loader's order: the epoch's shuffle, samples in order
    order = np.arange(N_SAMPLES)
    np.random.default_rng(7 + 977 * 1).shuffle(order)
    first = ds[int(order[0])]["img_left"]
    assert torch.equal(host[0]["img_left"][0],
                       torch.from_numpy(np.asarray(first, np.float32)))
