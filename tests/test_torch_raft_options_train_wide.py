"""One train step of the RAFT-Stereo option sets at wider shapes,
``downsample=1`` (features at 1/2) and ``hidden_dims=(96, 96, 96)``, in the
PyTorch port against the JAX package's, on the CPU: as
``test_torch_raft_options_train.py`` checks the others, at its tolerances.
"""

import pytest

pytest.importorskip("torch")

from test_torch_raft_options_train import check_train_step  # noqa: E402


@pytest.mark.parametrize("name", ["ds1", "hidden96"])
def test_wide_option_set_train_step_matches_jax(name):
    check_train_step(name)
