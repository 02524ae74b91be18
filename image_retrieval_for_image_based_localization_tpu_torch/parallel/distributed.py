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
``gallery`` axis). Without an initialized process group they return their
input: the same code at world size 1. NCCL takes CUDA tensors and gloo CPU
tensors, so a tensor is moved to the backend's device and back.
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
) -> bool:
    """Join the process group from the arguments or the environment. Returns
    True when a group of more than one process was initialized, False (and
    does nothing) for one process.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of process
    0. On CUDA, process ``i`` takes card ``i % device_count`` before it
    joins.
    """
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
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=url,
                            world_size=int(num_processes), rank=int(process_id))
    return True


def is_primary() -> bool:
    """True in process 0, and in a run of one process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _backend_device() -> Optional[torch.device]:
    """Where the group's collectives take tensors; None without a group."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_cols(t: torch.Tensor) -> torch.Tensor:
    """Concatenate every process's ``t`` (equal shapes) along dim 1, in rank
    order, on ``t``'s device."""
    dev = _backend_device()
    if dev is None:
        return t
    x = t.to(dev).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=1).to(t.device)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of every process's ``t`` (equal shapes), on ``t``'s device."""
    dev = _backend_device()
    if dev is None:
        return t
    x = t.to(dev).clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    return x.to(t.device)
