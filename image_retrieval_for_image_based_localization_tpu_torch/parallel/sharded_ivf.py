"""Multi-device IVF over a cluster-sharded gallery: the JAX package's
``parallel/sharded_ivf.py`` on ``torch.distributed``.

The padded partitions ``[C, L, D]`` are split by whole clusters over the
mesh's ``gallery`` axis (pad clusters have length 0), replicated over
``data``; each process holds its first data row's shards and merges within
that row's gallery group. Search has global-nprobe semantics:

1. each shard scores the queries against its own centroids; the coarse
   scores ``[nq, C]`` are all-gathered, so every shard knows the global
   nprobe-th coarse score, the probe threshold;
2. each shard probes its own clusters that reach the threshold (ties at the
   boundary over-include, never drop) and scores their rows exactly, with
   the partition dtype's rule of ``retrieval.ivf`` (f32, bf16 with the
   queries rounded to bf16, int8 scaled by 1/127);
3. the shards' (k score, k row) partials are all-gathered, the stable top-k
   taken and ordered by (score desc, row asc); fill slots return row -1
   (``sanitize_fill_rows``).

The probed clusters are single-device ``IVFIndex.search``'s (plus boundary
ties), so on tie-free data the results equal it, and at ``nprobe == C``
they are exact search. No TPU kernel runs here in the JAX package either:
this is plain torch, reusing ``retrieval.ivf``.
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
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import (
    IVFIndex,
    as_f32,
    order_by_score_then_row,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    INT32_MAX,
    NEG_INF,
    sanitize_fill_rows,
    stable_topk,
)


def _probe_shard(shard, q, cs_l, thresh, P_l: int, k_loc: int):
    """Step 2 on one shard: its qualifying clusters, exact scores of their
    rows, the shard's top ``k_loc`` (score, global row)."""
    _, parts, lengths, row_ids = shard
    qual = torch.where(cs_l >= thresh[:, None], cs_l, torch.full_like(cs_l, NEG_INF))
    q_s, sel = stable_topk(qual, P_l)                      # [nq, P_l]
    active = q_s > NEG_INF / 2
    sub = parts[sel]                                       # [nq, P_l, L, D]
    if parts.dtype == torch.int8:
        scores = torch.einsum("qd,qpld->qpl", q, sub.float()) * (1.0 / 127.0)
    else:
        scores = torch.einsum("qd,qpld->qpl", q.to(parts.dtype).float(), sub.float())
    L = parts.shape[1]
    valid = ((torch.arange(L, device=q.device)[None, None, :] < lengths[sel][:, :, None])
             & active[:, :, None])
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    rows = torch.where(valid, row_ids[sel], torch.full_like(row_ids[sel], INT32_MAX))
    nq = q.shape[0]
    s, pos = stable_topk(scores.reshape(nq, -1), k_loc)
    return s, torch.gather(rows.reshape(nq, -1), 1, pos)


def sharded_ivf_search(
    shards: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]],
    queries: torch.Tensor,
    k: int,
    nprobe: int,
    mesh: Mesh,
    axis: str = "gallery",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed IVF probe over this process's cluster shards, each
    ``(centroids [C_l, D], partitions [C_l, L, D], lengths [C_l], row_ids
    [C_l, L])`` on its device. Pad clusters must have length 0. Returns
    ``(scores, rows) [nq, k]`` on the queries' device, the same on every
    process; fill slots are (NEG_INF, INT32_MAX)."""
    out = queries.device
    C_l, L = shards[0][1].shape[:2]
    C = C_l * mesh.shape[axis]
    P_l = min(nprobe, C_l)        # the most clusters one shard can probe
    k_loc = min(k, P_l * L)
    cs_local = []
    for cent, _, lengths, _ in shards:   # 1. coarse scores, gathered
        cs = queries.to(cent.device) @ cent.T
        cs_local.append(torch.where(lengths[None, :] > 0, cs, torch.full_like(cs, NEG_INF)))
    cs = all_gather_cols(torch.cat([c.to(out) for c in cs_local], dim=1),
                         mesh.gallery_group)                                  # [nq, C]
    thresh = stable_topk(cs, min(nprobe, C))[0][:, -1]
    parts_s, parts_r = [], []
    for shard, cs_l in zip(shards, cs_local):   # 2. each shard's qualifying clusters
        dev = cs_l.device
        s, r = _probe_shard(shard, queries.to(dev), cs_l, thresh.to(dev), P_l, k_loc)
        parts_s.append(s.to(out))
        parts_r.append(r.to(out))
    s_all = all_gather_cols(torch.cat(parts_s, dim=1), mesh.gallery_group)   # 3. merge
    r_all = all_gather_cols(torch.cat(parts_r, dim=1), mesh.gallery_group)
    s_top, pos = stable_topk(s_all, k)
    return order_by_score_then_row(s_top, torch.gather(r_all, 1, pos))


class ShardedIVF:
    """An ``IVFIndex`` whose partitions are sharded by clusters over the
    mesh (without a ``mesh``: ``default_mesh`` on the index's device)."""

    def __init__(self, ivf: IVFIndex, mesh: Optional[Mesh] = None, axis: str = "gallery"):
        self.mesh = mesh if mesh is not None else default_mesh(ivf.device)
        self.axis = axis
        self.n = ivf.n
        n_shards = self.mesh.shape[axis]
        C = ivf.centroids.shape[0]
        pad = (-C) % n_shards
        parts = ivf.partitions
        parts = parts if isinstance(parts, torch.Tensor) else torch.from_numpy(parts)
        cent = torch.from_numpy(ivf.centroids)
        lengths = torch.from_numpy(ivf.lengths)
        row_ids = torch.from_numpy(ivf.row_ids)
        if pad:  # pad clusters: zero rows, length 0 (masked at the coarse stage)
            cent = torch.cat([cent, cent.new_zeros((pad, cent.shape[1]))])
            parts = torch.cat([parts, parts.new_zeros((pad,) + tuple(parts.shape[1:]))])
            lengths = torch.cat([lengths, lengths.new_zeros(pad)])
            row_ids = torch.cat([row_ids, row_ids.new_zeros((pad, row_ids.shape[1]))])
        self.n_clusters = C + pad
        C_l = self.n_clusters // n_shards
        self.shards = []
        for j in self.mesh.gallery_shards:
            g = self.mesh.gallery_index(j)
            self.shards.append(tuple(t[g * C_l:(g + 1) * C_l].to(self.mesh.local_devices[j])
                                     .contiguous()
                                     for t in (cent, parts, lengths, row_ids)))

    def search(self, queries, k: int = 10, nprobe: int = 8) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate top-k: ``(scores [nq, k], gallery rows [nq, k])``,
        fill slots row -1; k is clamped as ``IVFIndex.search`` clamps it."""
        dev = self.mesh.local_devices[0]
        L, D = self.shards[0][1].shape[1:]
        q = as_f32(queries, dev).reshape(-1, D)
        P = min(nprobe, self.n_clusters)
        k_eff = min(k, self.n, P * L)
        s, r = sharded_ivf_search(self.shards, q, k=k_eff, nprobe=P, mesh=self.mesh,
                                  axis=self.axis)
        s = s.cpu().numpy()
        return s, sanitize_fill_rows(s, r.cpu().numpy())
