"""Model export for deployment: one ``torch.export`` artifact a server runs
with no model code.

Counterpart of ``stereoformer_tpu/export.py``, with its functions and
names. ``torch.export`` traces the eval forward once, with the trained
parameters inside, and ``save_exported`` writes the program and its
weights to one file. A server loads it with ``load_exported``, which
imports only what registers the kernels' custom ops
(``stereoformer_tpu_torch.ops``, ``kernels``): never ``models`` or ``nn``.
Every kernel entry the forward reaches is a ``stereoformer::`` op
(``kernels.OPS``), one node of the graph that the artifact calls by name:
the hand-written kernel for CUDA tensors, the plain version for CPU
tensors.

The batch dimension is symbolic (``torch.export.Dim``): one artifact
serves any batch size up to ``MAX_BATCH``. H and W stay static, as in the
JAX package: export one artifact per serving resolution. The inputs are
float32 images [B, H, W, 3], for a model built in float32 or in bf16
(``get_model(name, dtype=torch.bfloat16)``).
"""

from __future__ import annotations

import inspect
import os
import weakref
from typing import Optional

import torch

from . import ops  # noqa: F401  (registers the stereoformer:: ops)

# the example batch of a symbolic export: 0 and 1 would be specialised
_EXAMPLE_BATCH = 2
# the largest batch a symbolic artifact serves. CUDA ops bound the batch
# themselves (on the H100 some grids hold 2 B <= 65535: the siamese
# backbones run both images as one batch), and torch.export fails on a
# symbolic dimension whose range their guards would cut
MAX_BATCH = 1024


class _Infer(torch.nn.Module):
    """The eval forward's last disparity [B, H, W, 1]."""

    def __init__(self, model: torch.nn.Module, iters: int):
        super().__init__()
        self.model = model
        self.iters = iters
        # RAFT computes only the last upsampled disparity in test_mode
        self.kwargs = ({"test_mode": True} if "test_mode" in
                       inspect.signature(model.forward).parameters else {})

    def forward(self, left, right):
        return self.model(left, right, iters=self.iters,
                          **self.kwargs)["disparities"][-1]


def make_infer_fn(model: torch.nn.Module, iters: int = 12) -> torch.nn.Module:
    """The inference module, with the trained parameters inside: ``model``
    in eval mode, its last disparity."""
    return _Infer(model.eval(), iters).eval()


def export_model(model: torch.nn.Module, height: int, width: int,
                 iters: int = 12, batch: Optional[int] = None):
    """Trace the eval forward on example inputs on the model's device;
    returns a ``torch.export.ExportedProgram``. ``batch=None`` exports a
    symbolic batch dimension (one artifact, any batch size up to
    ``MAX_BATCH``)."""
    device = next(model.parameters()).device
    # two tensors: one passed twice would be traced as one input
    example = tuple(torch.zeros((batch or _EXAMPLE_BATCH, height, width, 3),
                                device=device) for _ in range(2))
    dynamic = None
    if batch is None:
        b = torch.export.Dim("batch", max=MAX_BATCH)
        dynamic = ({0: b}, {0: b})
    with torch.no_grad():
        return torch.export.export(make_infer_fn(model, iters),
                                   example,
                                   dynamic_shapes=dynamic)


def save_exported(exported, path: str) -> int:
    """Serialize an ``ExportedProgram`` to ``path``; returns the byte
    size."""
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load_exported(path: str):
    """Deserialize an artifact (an ``ExportedProgram``, on the device it
    was exported on); ``infer_exported`` runs it. Needs no model code."""
    return torch.export.load(path)


# an ExportedProgram's runnable module, made once
_modules: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def infer_exported(exported, left: torch.Tensor,
                   right: torch.Tensor) -> torch.Tensor:
    """Run an artifact on float32 images [B, H, W, 3] (any B for a
    symbolic batch); returns the disparity [B, H, W, 1]."""
    module = _modules.get(exported)
    if module is None:
        module = _modules[exported] = exported.module()
    with torch.inference_mode():
        return module(left.float(), right.float())
