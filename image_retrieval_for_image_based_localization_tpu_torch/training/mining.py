"""Hard-negative mining, the JAX package's ``training/mining.py``.

cirtorch re-mines tuples every epoch (``create_epoch_tuples``): sample
``qsize`` query pairs and a ``poolsize`` negative pool, extract descriptors
with the current model, search each query against the pool, and keep the
hardest negatives whose cluster differs from the query's, at most one per
cluster. The search is the port's exact ``retrieval.knn.knn_search`` on the
mining device (on the card: the score/block-max kernel); the cluster filter
is a copy of the JAX package's vectorized NumPy one. The same ``RandomState``
draws come in the same order, so a seed gives the JAX package's sample.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import knn_search
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


@dataclasses.dataclass
class TupleSet:
    """Epoch tuples: for each query, one positive and ``n_neg`` negatives."""

    qidxs: np.ndarray   # [Nq] pool indices of queries
    pidxs: np.ndarray   # [Nq] pool indices of positives
    nidxs: np.ndarray   # [Nq, n_neg] pool indices of mined negatives


def _filter_candidates(
    cand: np.ndarray,
    qidxs: np.ndarray,
    pidxs: np.ndarray,
    clusters: Optional[np.ndarray],
    n_neg: int,
) -> np.ndarray:
    """Ranked candidates ``cand [Nq, k]`` -> ``[Nq, n_neg]`` negatives (-1 =
    shortfall): drop the query and its positive and the query's cluster,
    keep the first (hardest) candidate of each cluster, take the first
    ``n_neg`` survivors in rank order. The reference's sequential scan,
    vectorized."""
    Nq, k = cand.shape
    valid = (cand != qidxs[:, None]) & (cand != pidxs[:, None])
    if clusters is not None:
        clusters = np.asarray(clusters, np.int64)
        ccl = clusters[cand]
        valid &= ccl != clusters[qidxs][:, None]
        # first occurrence per (row, cluster) among valid candidates, in
        # candidate order: invalid slots get a unique sentinel key so they
        # never claim a cluster, then key changes are marked in a stable sort
        ncl = int(clusters.max()) + 1
        rows64 = np.arange(Nq, dtype=np.int64)[:, None]
        key = rows64 * ncl + ccl
        sentinel = Nq * np.int64(ncl) + rows64 * k + np.arange(k, dtype=np.int64)
        key = np.where(valid, key, sentinel)
        order = np.argsort(key, axis=1, kind="stable")  # ties keep rank order
        sk = np.take_along_axis(key, order, axis=1)
        first_sorted = np.concatenate(
            [np.ones((Nq, 1), bool), sk[:, 1:] != sk[:, :-1]], axis=1
        )
        first = np.empty_like(valid)
        np.put_along_axis(first, order, first_sorted, axis=1)
        valid &= first

    rank = np.cumsum(valid, axis=1) - 1
    out = np.full((Nq, n_neg), -1, np.int64)
    rows, cols = np.nonzero(valid & (rank < n_neg))
    out[rows, rank[rows, cols]] = cand[rows, cols]
    return out


def mine_hard_negatives(
    pool_vecs: np.ndarray,
    qidxs: Sequence[int],
    pidxs: Sequence[int],
    clusters: Optional[np.ndarray] = None,
    n_neg: int = 5,
    pool_topk: int = 200,
    seed: int = 0,
    neg_pool: Optional[np.ndarray] = None,
    device: DeviceLike = "cuda",
) -> TupleSet:
    """The hardest negatives per query from pool descriptors.

    pool_vecs: [N, D] L2-normalized descriptors (uploaded to ``device`` for
    the search); qidxs/pidxs: matching query/positive rows; clusters: [N]
    cluster ids (negatives come from other clusters) or None; pool_topk:
    nearest pool rows considered per query; seed: the ``RandomState`` of the
    degenerate-pool filler; neg_pool: the rows eligible as negatives
    (default all).
    """
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    qidxs = np.asarray(qidxs)
    pidxs = np.asarray(pidxs)
    N = pool_vecs.shape[0]
    if neg_pool is None:
        gallery = pool_vecs
        k = min(pool_topk, N)
    else:
        neg_pool = np.asarray(neg_pool)
        gallery = pool_vecs[neg_pool]
        k = min(pool_topk, len(neg_pool))
    g = torch.from_numpy(np.ascontiguousarray(gallery, np.float32)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(pool_vecs[qidxs], np.float32)).to(dev)
    _, idx = knn_search(g, q, k=k)
    cand = idx.cpu().numpy().astype(np.int64)
    if neg_pool is not None:
        cand = neg_pool[cand]  # back to global pool indices

    nidxs = _filter_candidates(
        cand, qidxs, pidxs, None if clusters is None else np.asarray(clusters), n_neg,
    )
    # degenerate tiny pools: fill shortfalls with random non-q/p images, a
    # bounded number of draws, then a deterministic scan of the pool
    short_rows = np.nonzero((nidxs < 0).any(axis=1))[0]
    for qi in short_rows:
        picked = [int(v) for v in nidxs[qi] if v >= 0]
        tries = 0
        while len(picked) < n_neg and tries < 64:
            tries += 1
            filler = (
                rng.randint(0, N)
                if neg_pool is None
                else int(neg_pool[rng.randint(0, len(neg_pool))])
            )
            if filler != qidxs[qi] and filler != pidxs[qi]:
                picked.append(filler)
        if len(picked) < n_neg:
            fallback = [i for i in range(N) if i != qidxs[qi] and i != pidxs[qi]]
            if not fallback:
                raise ValueError(
                    "mining pool contains only the query and its positive; "
                    "cannot fill negatives"
                )
            while len(picked) < n_neg:
                picked.append(fallback[len(picked) % len(fallback)])
        nidxs[qi] = picked
    return TupleSet(qidxs=qidxs, pidxs=pidxs, nidxs=nidxs)


def mine_epoch_tuples(
    extract: Callable[[Sequence[str]], np.ndarray],
    paths: Sequence[str],
    qidxs: np.ndarray,
    pidxs: np.ndarray,
    clusters: Optional[np.ndarray] = None,
    n_neg: int = 5,
    pool_topk: int = 200,
    seed: int = 0,
    qsize: Optional[int] = None,
    poolsize: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> TupleSet:
    """Reference-style per-epoch tuples: draw ``qsize`` query pairs and a
    ``poolsize`` negative pool (``RandomState(seed)``, seed = the epoch),
    extract descriptors for the union of sampled rows only, then mine.
    Returned indices are global pool indices."""
    rng = np.random.RandomState(seed)
    qidxs = np.asarray(qidxs)
    pidxs = np.asarray(pidxs)
    if qsize is not None and qsize < len(qidxs):
        sel = np.sort(rng.choice(len(qidxs), qsize, replace=False))
        qidxs, pidxs = qidxs[sel], pidxs[sel]
    N = len(paths)
    if poolsize is not None and poolsize < N:
        neg_pool = np.sort(rng.choice(N, poolsize, replace=False))
    else:
        neg_pool = np.arange(N)

    union = np.unique(np.concatenate([qidxs, pidxs, neg_pool]))
    vecs = extract([paths[int(i)] for i in union])
    remap = np.full(N, -1, np.int64)
    remap[union] = np.arange(len(union))
    ts = mine_hard_negatives(
        vecs,
        remap[qidxs],
        remap[pidxs],
        clusters=None if clusters is None else np.asarray(clusters)[union],
        n_neg=n_neg,
        pool_topk=pool_topk,
        seed=seed,
        neg_pool=remap[neg_pool],
        device=device,
    )
    return TupleSet(qidxs=qidxs, pidxs=pidxs, nidxs=union[ts.nidxs])
