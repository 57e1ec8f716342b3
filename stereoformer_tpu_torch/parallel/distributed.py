"""Process groups and each rank's share of a global batch.

Counterpart of ``stereoformer_tpu/parallel/distributed.py``. JAX runs one
process per host and one mesh over every chip of every host; the port runs
one process (a rank) per device, in one ``torch.distributed`` group:

1. every rank calls :func:`initialize_multihost` before its first
   collective (a launcher such as ``torchrun`` sets ``MASTER_ADDR``,
   ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``);
2. ``parallel.make_mesh`` builds the 1-D data mesh over the group;
3. each rank loads only its rows of every global batch
   (:func:`host_shard_slice`) and puts them on its device
   (:func:`global_batch_from_host_local`);
4. the train step (``train.make_train_step(..., mesh=)``) all-reduces the
   BatchNorm moments, the loss denominators and the gradients.

In one process with no launcher every helper here is the identity: the
rows are all of them.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> bool:
    """Initialise ``torch.distributed`` from the arguments or from a
    launcher's environment (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). Returns True when it made a group (also of one rank, where
    the caller asked for one), False in a plain process with neither, where
    it does nothing, as JAX's does.

    ``device`` is this rank's device, by default ``cuda:LOCAL_RANK``; the
    backend follows it (NCCL for CUDA, gloo for the CPU) unless ``backend``
    names one: two ranks that share one card need gloo, which NCCL
    refuses."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError(
            "a process group needs the coordinator's address, the number of "
            "processes and this process's rank (arguments, or MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK)")
    dev = torch.device(device if device is not None
                       else f"cuda:{int(env.get('LOCAL_RANK', 0))}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def process_count() -> int:
    """The ranks in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def host_shard_slice(global_batch: int) -> slice:
    """The [start, stop) rows of a global batch that this rank loads."""
    per = global_batch // process_count()
    start = per * process_index()
    return slice(start, start + per)


def global_batch_from_host_local(batch: dict, mesh) -> dict:
    """This rank's rows of the global batch (numpy arrays or tensors) as
    tensors on its device; other values (file names) pass through. The step
    that takes them sees the whole global batch through its collectives."""
    from . import mesh_device

    dev = mesh_device(mesh)
    return {k: (torch.as_tensor(v).to(dev) if hasattr(v, "shape") else v)
            for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group's ranks; its gradient is the sum of the
    ranks' cotangents, since every rank's output reads every rank's
    input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, with the gradient flowing
    back through it (``torch.distributed.nn.functional.all_reduce`` has the
    same rule and is deprecated)."""
    return _AllReduceSum.apply(x, group)


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, outside autograd (a loss's
    denominator, a metric); ``x`` as it is where ``group`` is None."""
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def group_size(group) -> int:
    """The ranks in ``group``; 1 where it is None."""
    return 1 if group is None else dist.get_world_size(group)
