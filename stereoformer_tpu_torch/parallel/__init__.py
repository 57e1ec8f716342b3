"""Data-parallel meshes and batch helpers.

Counterpart of ``stereoformer_tpu/parallel/__init__.py``. JAX expresses data
parallelism as a ``Mesh`` with the batch sharded on its ``data`` axis and
lets XLA insert the collectives. The port runs one process per device
(``parallel.distributed``): the mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` over the process group, each
rank holds its rows of the global batch, and the train step
(``train.make_train_step(..., mesh=)``) all-reduces what JAX's compiler
would: the BatchNorm moments (``nn.norm.synced_statistics``), the loss
denominators and the gradients. The values are the one-process step's on
the whole batch.

Not ported: ``make_mesh_2d`` (it comes with W-sharding), and
``batch_sharding`` / ``replicated``, ``NamedSharding`` objects that have no
counterpart here: a rank holds its rows (``shard_batch``) and whole
parameters (``shard_params``), or its shards of them (``parallel.fsdp``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import (
    global_batch_from_host_local,
    host_shard_slice,
    initialize_multihost,
    process_count,
    process_index,
)


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = "data"):
    """The 1-D data mesh over the default process group. ``devices`` lists
    each rank's device in rank order (the same card may stand twice, under
    gloo); by default every rank's current CUDA device under NCCL, the CPU
    otherwise. Raises without a group: call ``initialize_multihost``
    first."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group, one rank a "
                           "device: call parallel.initialize_multihost first")
    n = dist.get_world_size()
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
        device_type = devices[dist.get_rank()].type
        if device_type == "cuda":
            torch.cuda.set_device(devices[dist.get_rank()])
    else:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis_name,))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def host_local_batch(global_batch: int) -> int:
    """Each rank's batch size for the per-rank input pipeline."""
    return global_batch // process_count()


def pad_batch_to(batch: dict, size: int) -> dict:
    """Zero-pad every array's batch dimension to ``size`` (divisibility by
    the mesh, or a fixed last batch)."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, "ndim") and v.shape[0] < size:
            pad = [(0, size - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
            out[k] = np.pad(np.asarray(v), pad)
        else:
            out[k] = v
    return out


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch, as tensors on its device; other
    values pass through. The batch must divide by the mesh."""
    n, rank = mesh.size(), mesh.get_local_rank()
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "shape"):
            out[k] = v
            continue
        if v.shape[0] % n:
            raise ValueError(f"{k}: a batch of {v.shape[0]} rows does not "
                             f"divide by the {n}-rank mesh")
        per = v.shape[0] // n
        out[k] = torch.as_tensor(v[rank * per:(rank + 1) * per]).to(
            mesh_device(mesh))
    return out


@torch.no_grad()
def shard_params(params, mesh):
    """Make every rank's copy rank 0's: each parameter and buffer of a
    module (or each tensor of a dict) broadcast from rank 0, in place.
    Returns ``params``."""
    if isinstance(params, torch.nn.Module):
        tensors = list(params.parameters()) + list(params.buffers())
    else:
        tensors = list(params.values())
    group = mesh.get_group()
    for t in tensors:
        dist.broadcast(t.data, src=dist.get_global_rank(group, 0),
                       group=group)
    return params


from .fsdp import (  # noqa: E402  (ZeRO-style sharded state, see fsdp.py)
    fsdp_shardings,
    fsdp_spec,
    shard_state_fsdp,
)

__all__ = [
    "fsdp_shardings",
    "fsdp_spec",
    "global_batch_from_host_local",
    "host_local_batch",
    "host_shard_slice",
    "initialize_multihost",
    "make_mesh",
    "mesh_device",
    "pad_batch_to",
    "process_count",
    "process_index",
    "shard_batch",
    "shard_params",
    "shard_state_fsdp",
]
