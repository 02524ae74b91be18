"""Row-sharded gallery with distributed exact top-k: the JAX package's
``parallel/sharded_index.py`` on ``torch.distributed``.

The gallery is padded to whole shards and split by rows over the mesh's
``gallery`` axis (``parallel.mesh``): on a ``D x G`` mesh, G row shards,
replicated over ``data``. Each process uploads only the shards of its first
data row (the others would hold the same rows) and the queries are
replicated. A query runs in three steps:

1. each local shard runs the streaming top-k (``retrieval.knn.knn_search``,
   kernel B3 on the card) with ``n_valid`` masking its pad rows and
   ``index_offset`` giving global rows; every shard returns exactly
   ``min(k, local_rows)`` columns, so the collective's tensors have equal
   shapes, and a shard with no valid row returns only NEG_INF fill;
2. the local partials are concatenated in shard order and all-gathered in
   rank order within the data row's gallery group (skipped when that group
   is this process alone);
3. a stable ``merge_topk`` picks the result. The partials arrive in
   ascending global-row order and each is sorted by (score desc, row asc),
   so on equal scores the lower row wins, as on one device.

A row's score is the bits one device computes for it (kernel B3 keeps one
FMA order per pair; the CPU route scores fixed tiles), so the result equals
single-device ``knn_search`` bit for bit, ties included.

:func:`sharded_rank_candidates` is the streaming mAP path:
``knn.rank_candidates_core`` over the local shards, partial candidate
scores and counts summed and all-reduced, so no ``[Ng, Nq]`` matrix exists
anywhere. On the card each shard scores through kernel B3, so the ranks
are those of one device's B3 scores bit for bit; single-device
``rank_candidates`` scores with cuBLAS, whose roundings differ from B3's,
and may order a near tie (scores within a few 1e-6) the other way.
"""

from __future__ import annotations

import functools
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.whitening import whiten_apply
from image_retrieval_for_image_based_localization_tpu_torch.parallel.distributed import (
    all_gather_cols,
    all_reduce_sum,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    knn_search,
    merge_topk,
    rank_candidates_core,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import DeviceLike


def _shard_layout(shards: Sequence[torch.Tensor], mesh: Mesh, n_valid: int):
    """(global row offset, valid rows) of each of this process's gallery
    shards (``mesh.gallery_shards``, in order): the shard's ``gallery``
    coordinate times ``local_rows``, pads at the global end."""
    local_rows = shards[0].shape[0]
    out = []
    for j in mesh.gallery_shards:
        offset = mesh.gallery_index(j) * local_rows
        out.append((offset, int(np.clip(n_valid - offset, 0, local_rows))))
    return out


def sharded_knn(
    shards: Sequence[torch.Tensor],
    queries: torch.Tensor,
    k: int,
    mesh: Mesh,
    n_valid: int,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed exact top-k over a row-sharded gallery.

    Args:
      shards: this process's gallery shards (``mesh.gallery_shards``),
        ``[local_rows, D]`` each, in order (pad rows at the global end).
      queries: ``[Nq, D]`` f32, the same on every process.
      k: at most ``n_valid``.
      n_valid: number of real gallery rows.
    Returns ``(scores [Nq, k], global rows [Nq, k] int32)`` on the queries'
    device, the same on every process.
    """
    out = queries.device
    parts_s, parts_i = [], []
    for g, (offset, valid) in zip(shards, _shard_layout(shards, mesh, n_valid)):
        s, i = knn_search(g, queries.to(g.device), k, chunk=chunk, n_valid=valid,
                          index_offset=offset)
        parts_s.append(s.to(out))
        parts_i.append(i.to(out))
    s_all = all_gather_cols(torch.cat(parts_s, dim=1), mesh.gallery_group)
    i_all = all_gather_cols(torch.cat(parts_i, dim=1), mesh.gallery_group)
    s, i = merge_topk(s_all, i_all, k)
    return s, i.to(torch.int32)


def sharded_rank_candidates(
    shards: Sequence[torch.Tensor],
    queries: torch.Tensor,
    cand: torch.Tensor,
    mesh: Mesh,
    n_valid: int,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Global rank of each candidate row (``[Nq, C]`` int32) over a
    row-sharded gallery: ``rank_candidates_core`` over the local shards,
    the sums all-reduced over the data row's gallery group."""
    layout = _shard_layout(shards, mesh, n_valid)
    return rank_candidates_core(list(shards), queries, cand, chunk=chunk,
                                n_valid=[v for _, v in layout],
                                index_offset=[o for o, _ in layout],
                                reduce=functools.partial(all_reduce_sum, group=mesh.gallery_group),
                                stable=True)


def _host_rows(gallery, start: int, stop: int) -> torch.Tensor:
    """Rows ``[start, stop)`` of a host f32 array, a ``uint16`` bf16
    bit-view or a tensor, as a tensor (bf16 stays bf16)."""
    if isinstance(gallery, torch.Tensor):
        return gallery[start:stop]
    rows = np.ascontiguousarray(gallery[start:stop])
    if rows.dtype == np.uint16:
        with warnings.catch_warnings():  # a read-only memory map
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(rows).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(rows, np.float32))


class ShardedIndex:
    """A gallery sharded over the mesh's ``gallery`` axis, device-resident.

    ``gallery`` [N, D] is f32 (a numpy array or a tensor), or bf16 (a
    tensor, or the ``uint16`` bit-view ``Index.load`` gives). Every process
    passes the same gallery and uploads only its own gallery shards. Without
    a ``mesh`` it takes ``default_mesh(device)``.
    """

    def __init__(self, gallery, mesh: Optional[Mesh] = None, axis: str = "gallery",
                 m: Optional[np.ndarray] = None, P_: Optional[np.ndarray] = None,
                 dims: Optional[int] = None, device: DeviceLike = "cuda"):
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self.axis = axis
        self.m, self.P, self.dims = m, P_, dims
        self.n_valid = int(gallery.shape[0])
        n_shards = self.mesh.shape[axis]
        self.local_rows = -(-self.n_valid // n_shards)
        D = gallery.shape[1]
        self.shards: List[torch.Tensor] = []
        for j in self.mesh.gallery_shards:
            dev = self.mesh.local_devices[j]
            start = self.mesh.gallery_index(j) * self.local_rows
            rows = _host_rows(gallery, min(start, self.n_valid),
                              min(start + self.local_rows, self.n_valid))
            pad = self.local_rows - rows.shape[0]
            if pad:  # pad rows at the global end, zeros as in the JAX package
                rows = torch.cat([rows, rows.new_zeros((pad, D))])
            self.shards.append(rows.to(dev).contiguous())
        self._mP = None

    @property
    def device(self) -> torch.device:
        """Where queries and results live: the first local shard's device."""
        return self.mesh.local_devices[0]

    @classmethod
    def from_index(cls, index, mesh: Optional[Mesh] = None,
                   axis: str = "gallery") -> "ShardedIndex":
        """Shard an existing single-device ``retrieval.index.Index`` (its
        host gallery; without a ``mesh``, on the index's device)."""
        return cls(index.gallery, mesh=mesh, axis=axis, m=index.m, P_=index.P,
                   dims=index.dims, device=index.device)

    def transform_queries(self, q) -> torch.Tensor:
        """The index's whitening applied to query descriptors, on :attr:`device`."""
        q = torch.as_tensor(np.asarray(q, np.float32)).to(self.device)
        if q.dim() == 1:
            q = q[None, :]
        if self.P is None:
            return q
        if self._mP is None:
            self._mP = (torch.from_numpy(np.asarray(self.m, np.float32)).to(self.device),
                        torch.from_numpy(np.asarray(self.P, np.float32)).to(self.device))
        return whiten_apply(q, *self._mP, self.dims)

    def _queries(self, qdescriptors, pre_transformed: bool) -> torch.Tensor:
        if pre_transformed:
            return torch.as_tensor(np.asarray(qdescriptors, np.float32)).to(self.device)
        return self.transform_queries(qdescriptors)

    def gallery_host(self) -> torch.Tensor:
        """The whole gallery [n_valid, D] on the CPU, the shards of the data
        row gathered in order."""
        local = torch.cat([s.cpu() for s in self.shards])
        return all_gather_cols(local.T.contiguous(),
                               self.mesh.gallery_group).T[: self.n_valid].contiguous()

    def save(self, path: str) -> None:
        """Persist as a plain ``Index`` artifact (the shards gathered)."""
        from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index

        g = self.gallery_host()
        Index(gallery=g if g.dtype == torch.bfloat16 else g.numpy(), m=self.m, P=self.P,
              dims=self.dims, storage="bfloat16" if g.dtype == torch.bfloat16 else "float32",
              device=torch.device("cpu")).save(path)

    @classmethod
    def load(cls, path: str, mesh: Optional[Mesh] = None, axis: str = "gallery",
             device: DeviceLike = "cuda") -> "ShardedIndex":
        """Load an ``Index`` artifact saved by either package and shard it."""
        from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index

        return cls.from_index(Index.load(path, device=device), mesh=mesh, axis=axis)

    def rank_candidates(self, qdescriptors, cand, chunk: Optional[int] = None,
                        pre_transformed: bool = False) -> np.ndarray:
        """Global rank of each candidate row (``[Nq, C]`` int32): the
        streaming mAP path. ``pre_transformed=True`` skips the whitening
        (queries already in the search space, e.g. αQE-expanded ones)."""
        q = self._queries(qdescriptors, pre_transformed)
        cand = torch.as_tensor(np.asarray(cand, np.int64)).to(self.device)
        return sharded_rank_candidates(self.shards, q, cand, self.mesh, self.n_valid,
                                       chunk=chunk).cpu().numpy()

    def query(self, qdescriptors, k: int = 10, chunk: Optional[int] = None,
              pre_transformed: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Distributed exact top-k. Returns host ``(scores, indices)``."""
        q = self._queries(qdescriptors, pre_transformed)
        s, i = sharded_knn(self.shards, q, min(k, self.n_valid), self.mesh, self.n_valid,
                           chunk=chunk)
        return s.cpu().numpy(), i.cpu().numpy()
