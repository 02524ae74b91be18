"""Device mesh for data parallelism and the sharded gallery: the JAX
package's ``parallel/mesh.py``.

The JAX package scales through a ``jax.sharding.Mesh`` with two axes:
``data`` (batch parallelism for extraction and training) and ``gallery``
(the descriptor gallery sharded by rows). Here :class:`Mesh` keeps the same
axis names over ``torch.distributed`` processes, one process per card:

- the mesh's shards are a global list: each process owns a contiguous run
  of ``len(local_devices)`` of them, each on one of its local devices, so
  global shard id = ``rank * local_shards + local_id``. Several shards may
  share a device: four row shards on ``cuda:0``, or eight on the CPU as the
  JAX tests' eight virtual devices;
- shard ``s`` sits at ``(data, gallery) = (s // G, s % G)`` on a ``D x G``
  mesh, the row-major reshape of the JAX package's device array. A
  process's shards must cover whole data rows, or a data row whole
  processes, so every process takes part in the same collectives;
- the ``gallery`` collectives (the sharded search's merges) run within one
  data row (:attr:`Mesh.gallery_group`), the ``data`` collectives (the
  extraction's all-gather, train-mode BatchNorm's statistics and the
  gradients' mean) within one gallery column (:attr:`Mesh.data_group`).

The process group (``parallel.distributed``) carries the collectives. With
none initialized the mesh is one process (rank 0 of 1) and every group is
that process alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


def _group() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A ``(data, gallery)`` mesh of shards over the process group.

    ``shape`` maps each axis name to its global size, as
    ``jax.sharding.Mesh.shape`` does; ``local_devices`` holds one device per
    local shard, in shard order. A mesh made by :func:`create_mesh` carries
    the process subgroups of its data rows and gallery columns.
    """

    def __init__(self, shape: Dict[str, int], local_devices: Sequence[torch.device],
                 rank: int = 0, world_size: int = 1):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.local_devices = [torch.device(d) for d in local_devices]
        self.rank, self.world_size = int(rank), int(world_size)
        self.data_group = self.gallery_group = None

    @property
    def local_shards(self) -> int:
        return len(self.local_devices)

    def shard_id(self, local_id: int) -> int:
        """Global shard id of this process's ``local_id``-th shard."""
        return self.rank * self.local_shards + local_id

    def data_index(self, local_id: int) -> int:
        """The ``data`` coordinate of this process's ``local_id``-th shard."""
        return self.shard_id(local_id) // self.shape.get("gallery", 1)

    def gallery_index(self, local_id: int) -> int:
        """The ``gallery`` coordinate of this process's ``local_id``-th shard."""
        return self.shard_id(local_id) % self.shape.get("gallery", 1)

    @property
    def data_rows(self) -> List[int]:
        """Local id of the first shard of each data row this process holds,
        in order: the shards that compute a data-parallel slice (a row's
        other shards are its replicas over ``gallery``)."""
        firsts: Dict[int, int] = {}
        for j in range(self.local_shards):
            firsts.setdefault(self.data_index(j), j)
        return list(firsts.values())

    @property
    def gallery_shards(self) -> List[int]:
        """Local ids of this process's shards in its first data row: the
        ones its sharded searches use (the other rows hold replicas of the
        same gallery shards)."""
        d0 = self.data_index(0)
        return [j for j in range(self.local_shards) if self.data_index(j) == d0]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} of {self.world_size}, "
                f"local {[str(d) for d in self.local_devices]})")


def _subgroups(members: Sequence[Sequence[int]], rank: int, world: int):
    """The process group of ``rank`` among the partition ``members`` of the
    world: None for the whole world (the default group), else a
    ``dist.new_group`` made by every rank for every part, in one order."""
    if len(members) == 1:
        return None
    mine = None
    for ranks in members:
        g = dist.new_group(list(ranks))
        if rank in ranks:
            mine = g
    return mine


def create_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = ("data", "gallery"),
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A mesh over this process's ``devices`` (one shard each; repeats allowed)
    times the process group's world size.

    ``axis_sizes=None`` puts every shard on the last axis (pure gallery
    sharding); a ``-1`` entry is inferred from the shard count, as in the
    JAX package. ``devices`` defaults to :func:`local_devices`.
    """
    rank, world = _group()
    devs = [resolve_device(d) for d in (devices if devices is not None else local_devices())]
    n = len(devs) * world
    sizes = [1] * (len(axis_names) - 1) + [n] if axis_sizes is None else list(axis_sizes)
    if len(sizes) != len(axis_names):
        raise ValueError(f"{len(sizes)} axis sizes for axes {axis_names}")
    if -1 in sizes:
        sizes[sizes.index(-1)] = n // math.prod(s for s in sizes if s != -1)
    shape = dict(zip(axis_names, sizes))
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {sizes} != {n} shards ({len(devs)} local x {world} processes)")
    mesh = Mesh(shape, devs, rank=rank, world_size=world)
    G, L = shape.get("gallery", 1), len(devs)
    if G % L and L % G:
        raise ValueError(
            f"a gallery axis of {G} over {L} shards a process: a process's shards must "
            f"cover whole data rows, or a data row whole processes")
    if world > 1:
        q = max(G // L, 1)  # processes a data row spans
        mesh.gallery_group = _subgroups(
            [range(r, r + q) for r in range(0, world, q)], rank, world)
        mesh.data_group = _subgroups(
            [range(c, world, q) for c in range(q)], rank, world)
    return mesh


def local_devices(device: DeviceLike = "cuda"):
    """This process's devices, one shard each: with a process group of more
    than one process, the current card (one card a process); else every
    card of the host. ``device="cpu"`` gives one CPU shard."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    if _group()[1] > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_mesh(device: DeviceLike = "cuda") -> Mesh:
    """Every shard on the ``gallery`` axis (data axis 1): one shard per local
    device, times the process group's world size."""
    return create_mesh(devices=local_devices(device))
