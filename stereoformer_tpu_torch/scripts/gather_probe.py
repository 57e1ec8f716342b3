"""Row-gather probe: ``out = img[idx]`` along axis 0 on the card.

Counterpart of ``scripts/_gather_probe.py``, with the same sizes and the
same ``RandomState(0)`` draw: img [8640, 64] float32 and int32 row indices
constant along each row. It runs ``ops.take_rows`` (the CUDA kernel
``csrc/row_gather.cu`` on the card), checks the result against numpy, and
prints ``GATHER_PROBE_OK`` with the shape and the device.

    python -m stereoformer_tpu_torch.scripts.gather_probe [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gather import take_rows

HW, C = 8640, 64


def main(argv=None) -> torch.Tensor:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card by default; 'cpu' for the plain version")
    dev = resolve_device(parser.parse_args(argv).device)
    rng = np.random.RandomState(0)
    img = rng.randn(HW, C).astype(np.float32)
    # arbitrary-range row indices, constant across the row
    rows = rng.randint(0, HW, size=(HW, 1)).astype(np.int32)
    idx = np.broadcast_to(rows, (HW, C)).copy()
    out = take_rows(torch.from_numpy(img).to(dev), torch.from_numpy(idx).to(dev))
    np.testing.assert_array_equal(out.cpu().numpy(), img[rows[:, 0]])
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    print("GATHER_PROBE_OK", tuple(out.shape), f"{dev} ({name})")
    return out


if __name__ == "__main__":
    main()
