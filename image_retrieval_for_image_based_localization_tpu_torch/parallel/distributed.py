"""Multi-process runtime: the JAX package's ``parallel/distributed.py`` on
``torch.distributed``.

:func:`initialize_distributed` reads the JAX package's environment
variables (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``), so one launcher drives both packages, and does nothing
for one process, so every entry point may call it. The backend is ``nccl``
for CUDA devices and ``gloo`` on the CPU; nothing on a machine tells a
program of a cluster, so the coordinator address is always given.

:func:`all_gather_cols` and :func:`all_reduce_sum` are the collectives of
the sharded search (the JAX package's ``all_gather`` and ``psum`` over the
``gallery`` axis); :func:`all_gather_rows`, :func:`broadcast_` and
:func:`all_reduce_sum` again (the gradients' mean, and train-mode
BatchNorm's sums in its forward and backward,
``models.resnet._BatchNormTrain``) serve data parallelism over the ``data``
axis. Each takes a process ``group`` (None: the default group), as
``parallel.mesh.Mesh`` hands out. Without an initialized process group, or
over a group of one process, they return their input: the same code at
world size 1. NCCL takes CUDA tensors and gloo CPU tensors, so a tensor is
moved to the backend's device and back.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join the process group from the arguments or the environment. Returns
    True when a group of more than one process was initialized, False (and
    does nothing) for one process. A process already in a group stays in it
    (the answer is whether it holds more than one process), so a library
    entry point may call this in a program that joined before.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of process
    0. On CUDA, process ``i`` takes card ``i % device_count`` before it
    joins. ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on the CPU;
    ``gloo`` on CUDA lets two processes share one card, which NCCL refuses.
    """
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("JAX_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("a multi-process run needs process_id (or JAX_PROCESS_ID)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes), rank=int(process_id))
    return True


def is_primary() -> bool:
    """True in process 0, and in a run of one process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def group_size(group=None) -> int:
    """Processes in ``group`` (None: the default group); 1 without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _backend_device(group=None) -> Optional[torch.device]:
    """Where ``group``'s collectives take tensors; None without a group, or
    for a group of one process (nothing to exchange)."""
    if group_size(group) == 1:
        return None
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    dev = _backend_device(group)
    if dev is None:
        return t
    x = t.to(dev).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_gather_cols(t: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every process's ``t`` (equal shapes) along dim 1, in rank
    order, on ``t``'s device."""
    return _gather(t, 1, group)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every process's ``t`` (equal shapes) along dim 0, in rank
    order, on ``t``'s device."""
    return _gather(t, 0, group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of every process's ``t`` (equal shapes), on ``t``'s device."""
    dev = _backend_device(group)
    if dev is None:
        return t
    x = t.to(dev, copy=True)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(t.device)


def broadcast_(tensors, group=None) -> None:
    """Overwrite each tensor (in place) with the first process's of
    ``group``."""
    dev = _backend_device(group)
    if dev is None:
        return
    src = 0 if group is None else dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tensors:
            x = t.detach().to(dev).contiguous()
            dist.broadcast(x, src=src, group=group)
            t.copy_(x)
