"""The port's export on the CPU for models built in bf16
(``get_model(name, dtype=torch.bfloat16)``): ``LowCNN_gru`` and
``RAFT_Stereo`` exported at 32x64 with a symbolic batch, saved, loaded and
run at B=1 and B=3 against the live bf16 model (float32 images in, float32
disparities out), as ``test_torch_export.py`` runs the float32 models:
bit-equal, the same aten ops, and the bf16 ops ``corr_band_bf16`` and
``conv2d_fused_bf16`` in the graph."""

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from stereoformer_tpu_torch.models import get_model  # noqa: E402

from test_torch_export import ITERS, round_trip  # noqa: E402

# the stereoformer:: ops a bf16 forward calls at ITERS iterations
BF16_OP_CALLS = {"LowCNN_gru": {"corr_band_bf16": 1,
                                "local_soft_argmin": ITERS},
                 "RAFT_Stereo": {"conv2d_fused_bf16": 14}}


@pytest.mark.parametrize("name", sorted(BF16_OP_CALLS))
def test_bf16_export_round_trip_matches_the_live_model(name, tmp_path):
    model = get_model(name, device="cpu", dtype=torch.bfloat16)
    round_trip(model, str(tmp_path / f"{name}.pt2"), BF16_OP_CALLS[name])
