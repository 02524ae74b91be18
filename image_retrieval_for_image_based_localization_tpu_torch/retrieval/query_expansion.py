"""αQE / average query expansion: the JAX package's
``retrieval/query_expansion.py``.

After a first search each query becomes the L2-normalized weighted sum of
itself and its top-nQE gallery neighbours, weights ``w_i = max(s_i, 0)^α``
(Radenović et al., TPAMI 2018; ``α = 0`` is average QE). Everything is in
the index's search space (after whitening). The nQE search is
``knn.knn_search``, so on the card it runs kernel B3; the gather and the
weighted sum are plain tensor code on the gallery's device.

``Index.build(dba_nqe=...)`` applies the same expansion to the gallery
itself (database-side augmentation).
"""

from __future__ import annotations

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import knn_search


def expand_queries(gallery: torch.Tensor, queries: torch.Tensor, nqe: int = 50,
                   alpha: float = 3.0) -> torch.Tensor:
    """αQE: expanded, re-L2-normalized queries ``[Nq, D]`` f32 on the
    gallery's device. ``gallery`` (f32, bf16 or int8 storage) and
    ``queries`` must be in the same search space."""
    q = queries.to(gallery.device).float()
    scores, idx = knn_search(gallery, q, k=nqe)
    # neighbours come back f32 whatever the storage; int8 is the symmetric
    # x127 quantization of retrieval.index, so rescale them to cosine range
    nbrs = gallery[idx.long()].float()
    if gallery.dtype == torch.int8:
        nbrs = nbrs * (1.0 / 127.0)
    w = torch.clamp(scores, min=0.0) ** float(alpha)
    expanded = q + torch.einsum("qn,qnd->qd", w, nbrs)
    norm = torch.linalg.norm(expanded, dim=1, keepdim=True)
    return expanded / torch.clamp(norm, min=1e-6)


def expand_queries_host(gallery_rows, queries, scores, alpha: float = 3.0) -> np.ndarray:
    """Host expansion from gathered neighbour rows ``[Nq, nqe, D]`` and their
    scores ``[Nq, nqe]``: used after a search on a *sharded* gallery, where
    the few neighbour rows are gathered on the host. Returns [Nq, D] numpy."""
    q = np.asarray(queries, np.float32)
    w = np.maximum(np.asarray(scores, np.float32), 0.0) ** float(alpha)
    expanded = q + np.einsum("qn,qnd->qd", w, np.asarray(gallery_rows, np.float32))
    norm = np.linalg.norm(expanded, axis=1, keepdims=True)
    return expanded / np.maximum(norm, 1e-6)


def _rows_f32(gallery, idx: np.ndarray) -> np.ndarray:
    """Gallery rows as f32 numpy from a host f32 array, a ``uint16`` bf16
    bit-view or a tensor."""
    if isinstance(gallery, torch.Tensor):
        return gallery[torch.from_numpy(idx.astype(np.int64)).to(gallery.device)].float().cpu().numpy()
    rows = np.asarray(gallery)[idx]
    if rows.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(rows)).view(torch.bfloat16).float().numpy()
    return rows.astype(np.float32)


def expand_via_sharded(sindex, gallery, queries, nqe: int, alpha: float = 3.0) -> np.ndarray:
    """αQE when the first search runs on a sharded gallery
    (``parallel.ShardedIndex``): the nQE search is distributed, the
    ``[Nq, nqe]`` neighbour rows are gathered from the host ``gallery`` and
    the expansion runs on the host. Returns expanded queries already in the
    search space: pass ``pre_transformed=True`` to the next sharded call.
    The query path and the sharded evaluation share this one function."""
    nqe = min(int(nqe), sindex.n_valid)
    s0, i0 = sindex.query(queries, k=nqe)
    qt = sindex.transform_queries(queries).cpu().numpy()
    return expand_queries_host(_rows_f32(gallery, i0), qt, s0, alpha=alpha)
