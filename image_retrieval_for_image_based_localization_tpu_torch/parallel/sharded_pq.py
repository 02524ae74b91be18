"""Multi-device PQ: ADC search over row-sharded codes, the JAX package's
``parallel/sharded_pq.py`` on ``torch.distributed``.

The ``[N, M]`` uint8 codes are padded to whole shards and split by rows over
the mesh's ``gallery`` axis and replicated over ``data``, as
``parallel.sharded_index`` splits f32 rows; the codebooks are on every
shard's device. A query batch:

1. every shard builds the same ``[nq, M, 256]`` lookup tables;
2. each shard streams its codes through ``retrieval.pq.adc_topk_core``
   (the ADC kernel, B7, on the card) with ``n_valid`` and
   ``index_offset``;
3. the (k score, k global row) partials are all-gathered within the data
   row's gallery group and a stable
   ``merge_topk`` picks the global top-k, bit for bit single-device
   ``PQIndex.search``'s.

``refine=R`` rescores the top R rows exactly against the host f32 gallery
(which PQ exists to keep off the device) with ``pq.rescore_rows``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.parallel.distributed import (
    all_gather_cols,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_index import (
    _shard_layout,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import as_f32
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import merge_topk
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import (
    PQIndex,
    _build_luts,
    adc_topk_core,
    rescore_rows,
)


def sharded_adc_topk(
    codes: Sequence[torch.Tensor],
    codebooks: Sequence[torch.Tensor],
    queries: torch.Tensor,
    k: int,
    mesh: Mesh,
    n_valid: int,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed ADC top-k over this process's code shards (``[local_rows,
    M]`` uint8 each) with the codebooks ``[M, 256, ds]`` on each shard's
    device. Returns ``(scores [nq, k], global rows [nq, k] int32)`` on the
    queries' device, equal to single-device ``PQIndex.search`` bit for bit
    (pad rows score NEG_INF)."""
    out = queries.device
    parts_s, parts_i = [], []
    for c, books, (offset, valid) in zip(codes, codebooks, _shard_layout(codes, mesh, n_valid)):
        lut = _build_luts(books, queries.to(c.device))
        # the core clamps k and the chunk to the shard; the gathered width
        # shards * min(k, local_rows) always covers k (k <= n_valid)
        s, i = adc_topk_core(lut, c, k=k, chunk=chunk, n_valid=valid, index_offset=offset)
        parts_s.append(s.to(out))
        parts_i.append(i.to(out))
    s_all = all_gather_cols(torch.cat(parts_s, dim=1), mesh.gallery_group)
    i_all = all_gather_cols(torch.cat(parts_i, dim=1), mesh.gallery_group)
    s, i = merge_topk(s_all, i_all, k)
    return s, i.to(torch.int32)


class ShardedPQ:
    """PQ codes sharded by rows over the mesh (without a ``mesh``:
    ``default_mesh`` on the index's device). Queries are expected in the
    index's search space, as for ``ShardedIVF`` and ``IVFPQIndex``."""

    def __init__(self, pq: PQIndex, mesh: Optional[Mesh] = None, axis: str = "gallery"):
        self.mesh = mesh if mesh is not None else default_mesh(pq.device)
        self.axis = axis
        self.n = pq.n
        self.rotation = pq.rotation  # OPQ: queries are rotated for the LUTs
        n_shards = self.mesh.shape[axis]
        local_rows = -(-pq.codes.shape[0] // n_shards)
        codes = np.concatenate([pq.codes, np.zeros(
            (local_rows * n_shards - pq.codes.shape[0], pq.codes.shape[1]), np.uint8)])
        books = torch.from_numpy(pq.codebooks)
        self.codes, self.codebooks = [], []
        for j in self.mesh.gallery_shards:
            dev = self.mesh.local_devices[j]
            start = self.mesh.gallery_index(j) * local_rows
            self.codes.append(torch.from_numpy(codes[start : start + local_rows]).to(dev))
            self.codebooks.append(books.to(dev))

    def search(self, queries, k: int = 10, chunk: int = 65536, refine: int = 0,
               gallery=None) -> Tuple[np.ndarray, np.ndarray]:
        """Distributed ADC top-k; ``refine=R`` rescores the top-R rows
        exactly against the host f32 ``gallery``."""
        dev = self.mesh.local_devices[0]
        D = self.codebooks[0].shape[0] * self.codebooks[0].shape[2]
        q = as_f32(queries, dev).reshape(-1, D)
        qr = q if self.rotation is None else q @ torch.from_numpy(self.rotation).to(dev)
        k_eff = min(k, self.n)
        k_stage = min(max(refine, k_eff) if refine else k_eff, self.n)
        s, i = sharded_adc_topk(self.codes, self.codebooks, qr, k=k_stage, mesh=self.mesh,
                                n_valid=self.n, chunk=chunk)
        if refine:
            if gallery is None:
                raise ValueError("refine requires the host f32 gallery")
            cand = torch.sort(i.to(torch.int64), dim=1).values
            rows = np.asarray(gallery, np.float32)[np.clip(cand.cpu().numpy(), 0, self.n - 1)]
            s, i = rescore_rows(torch.from_numpy(rows).to(dev), q, cand, self.n, k=k_eff)
        return s.cpu().numpy(), i.cpu().numpy()
