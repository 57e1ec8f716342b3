"""FSDP / ZeRO-style sharded training state.

Counterpart of ``stereoformer_tpu/parallel/fsdp.py``. JAX places each leaf
of the train state (parameters and the AMSGrad moments) with a
``NamedSharding`` and lets XLA all-gather parameters at use and
reduce-scatter gradients; the update runs on each device's shard. The port
does the same with FSDP2 (``torch.distributed.fsdp.fully_shard`` on the
model, one group for the whole model): parameters become ``DTensor``s
sharded over the data mesh, each rank's AMSGrad moments take their
parameter's sharding, and ``train.Amsgrad`` updates each rank's shard. With
AMSGrad's three moments, a rank holds about 1/n of the state.

Sharding rule (JAX's): a leaf is split along its largest dimension that the
mesh divides, ties going to the trailing one, read in the JAX layout (a
conv's HWIO: O wins a tie). The port's weights are OIHW, so the rule runs
on the JAX shape (``weights.jax_layout``) and shards the parameter's axis
that holds the same logical one. JAX leaves a leaf of fewer than
``min_elems`` elements, or with no divisible dimension, replicated; FSDP2
shards every parameter of a group, so such a leaf is sharded on its first
axis (unevenly where it must be). Values do not change either way.
"""

from __future__ import annotations

import math
import sys
from typing import Sequence

import torch

__all__ = [
    "fsdp_shardings",
    "fsdp_spec",
    "full_tensor",
    "load_full",
    "local_tensor",
    "shard_state_fsdp",
]


def fsdp_spec(shape: Sequence[int], n: int, axis_name: str = "data",
              min_elems: int = 1024) -> tuple:
    """JAX's ``PartitionSpec`` for a leaf of (JAX-layout) ``shape`` on an
    ``n``-way axis, as a tuple: ``()`` replicated, else one entry per
    dimension, ``axis_name`` at the sharded one and None elsewhere."""
    shape = tuple(int(s) for s in shape)
    if n <= 1 or not shape or math.prod(shape) < min_elems:
        return ()
    best_dim, best_size = -1, 0
    for d, s in enumerate(shape):
        if s % n == 0 and s >= best_size:
            best_dim, best_size = d, s
    if best_dim < 0:
        return ()
    spec = [None] * len(shape)
    spec[best_dim] = axis_name
    return tuple(spec)


def fsdp_shardings(model: torch.nn.Module, mesh, axis_name: str = "data",
                   min_elems: int = 1024) -> dict:
    """Parameter name -> the axis of the port's parameter that holds JAX's
    sharded axis, or None where JAX replicates the leaf. ``mesh`` is the
    data mesh or its size."""
    from ..weights import jax_layout

    n = mesh if isinstance(mesh, int) else mesh.size()
    out = {}
    for name, _ in model.named_parameters():
        shape, axes = jax_layout(model, name)
        spec = fsdp_spec(shape, n, axis_name, min_elems)
        out[name] = axes[spec.index(axis_name)] if spec else None
    return out


def shard_state_fsdp(state, mesh, axis_name: str = "data",
                     min_elems: int = 1024):
    """Shard ``state`` (a ``train.TrainState``) over ``mesh`` in place:
    ``fully_shard`` the model by ``fsdp_shardings`` and give each AMSGrad
    moment its parameter's sharding, keeping its values. Returns
    ``(state, shardings)``. Every rank must hold the same state (built
    from one seed, or ``parallel.shard_params``)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    shardings = fsdp_shardings(state.model, mesh, axis_name, min_elems)
    params = dict(state.model.named_parameters())
    dim_of = {id(p): shardings[k] or 0 for k, p in params.items()}
    fully_shard(state.model, mesh=mesh,
                shard_placement_fn=lambda p: Shard(dim_of[id(p)]))
    params = dict(state.model.named_parameters())
    opt = state.opt_state
    for m in ("mu", "nu", "nu_max"):
        moments = getattr(opt, m)
        for k, p in params.items():
            sharded = torch.zeros_like(p)
            load_full(sharded, moments[k])
            moments[k] = sharded
    return state, shardings


def _is_dtensor(t) -> bool:
    # no tensor is a DTensor before torch.distributed.tensor is imported,
    # which takes over a second: a one-device run never pays for it
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _shard_of(full: torch.Tensor, dt) -> torch.Tensor:
    """This rank's piece of ``full`` under ``dt``'s one-axis sharding, as
    ``DTensor`` splits it (``torch.chunk``; a rank past the chunks holds
    none)."""
    (placement,) = dt.placements
    mesh = dt.device_mesh
    if not placement.is_shard():
        return full
    chunks = torch.chunk(full, mesh.size(), dim=placement.dim)
    rank = mesh.get_local_rank()
    if rank < len(chunks):
        return chunks[rank]
    return full.narrow(placement.dim, 0, 0)


@torch.no_grad()
def load_full(dst: torch.Tensor, full: torch.Tensor) -> None:
    """Copy the whole tensor ``full`` into ``dst``, in place: into this
    rank's shard where ``dst`` is a ``DTensor``."""
    if _is_dtensor(dst):
        local = dst.to_local()
        piece = _shard_of(full, dst)
        if piece.shape != local.shape:
            raise RuntimeError(f"a shard of {tuple(piece.shape)} for a local "
                               f"tensor of {tuple(local.shape)}")
        local.copy_(piece)
    else:
        dst.copy_(full)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor: gathered from every rank where ``t`` is a
    ``DTensor`` (a collective: every rank calls it), else ``t``."""
    return t.full_tensor() if _is_dtensor(t) else t


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor`` (its storage: an in-place update
    of it updates ``t``), or ``t``."""
    return t.to_local() if _is_dtensor(t) else t
