"""Retrieval as coarse localization: the shortlist hand-off to a pose solver.

The JAX package's ``localization.py`` (numpy only). Retrieval gives each
query its top-k database images; a 6-DoF pose pipeline (Aachen-style)
reads them as a "pairs" text file::

    <query_name> <db_name>
    ...

one line per (query, retrieved) pair, queries in order, k lines each, the
format structure-from-motion localizers (hloc and kin) read.
:func:`localization_recall` and :func:`localization_recall_from_ranks`
give the shortlist's recall@k, from a shortlist or from streamed candidate
ranks.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def retrieval_pairs(
    query_names: Sequence[str],
    db_names: Sequence[str],
    indices: np.ndarray,
) -> list[Tuple[str, str]]:
    """Flatten a top-k index matrix [Nq, k] into (query, db) name pairs."""
    pairs = []
    for qi, row in enumerate(indices):
        for db_i in row:
            pairs.append((query_names[qi], db_names[int(db_i)]))
    return pairs


def write_pairs_file(
    path: str,
    query_names: Sequence[str],
    db_names: Sequence[str],
    indices: np.ndarray,
) -> str:
    """Write the localization shortlist; returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for q, d in retrieval_pairs(query_names, db_names, indices):
            f.write(f"{q} {d}\n")
    return path


def localization_recall(
    indices: np.ndarray,
    gnd: Sequence[dict],
    ks: Sequence[int] = (1, 5, 10, 20),
    protocol: str = "medium",
) -> dict:
    """Recall@k of a retrieval shortlist — the coarse-localization success
    metric (a query localizes iff its top-k shortlist contains >= 1 correct
    database image; the standard headline number of visual-localization
    retrieval papers and the quantity the reference's shortlist hand-off is
    ultimately judged by).

    indices: ``[Nq, >=max(ks)]`` retrieved db rows per query (the shortlist
    order actually handed to the pose pipeline — junk images are NOT
    rank-shifted away here, because they occupy real shortlist slots).
    gnd: revisited (easy/hard/junk) or classic (ok/junk) per-query dicts;
    ``protocol`` picks the positive set for revisited gnd. Queries with no
    positives under the protocol are excluded (mAP convention).

    Returns ``{"ks": [...], "recall": {k: fraction}, "n_queries": int}``.
    """
    indices = np.atleast_2d(np.asarray(indices))
    nq = indices.shape[0]
    if nq != len(gnd):
        raise ValueError(f"{nq} shortlist rows vs {len(gnd)} gnd entries")
    ks = sorted(int(k) for k in ks)
    if ks and ks[-1] > indices.shape[1]:
        raise ValueError(
            f"recall@{ks[-1]} needs a shortlist of depth >= {ks[-1]}, "
            f"got {indices.shape[1]}")
    hits = {k: 0 for k in ks}
    n_eval = 0
    for i, g in enumerate(gnd):
        if "easy" in g or "hard" in g:
            easy = np.asarray(g.get("easy", []), np.int64)
            hard = np.asarray(g.get("hard", []), np.int64)
            pos = {
                "easy": easy,
                "medium": np.concatenate([easy, hard]),
                "hard": hard,
            }[protocol]
        else:
            pos = np.asarray(g.get("ok", []), np.int64)
        if len(pos) == 0:
            continue
        n_eval += 1
        pset = set(int(p) for p in pos)
        first = next(
            (r for r, d in enumerate(indices[i]) if int(d) in pset), None)
        for k in ks:
            if first is not None and first < k:
                hits[k] += 1
    denom = max(n_eval, 1)
    return {
        "ks": ks,
        "recall": {k: hits[k] / denom for k in ks},
        "n_queries": n_eval,
    }


def localization_recall_from_ranks(
    candidate_ranks: np.ndarray,
    gnd: Sequence[dict],
    ks: Sequence[int] = (1, 5, 10, 20),
    protocol: str = "medium",
) -> dict:
    """``localization_recall`` from a streaming ``[Nq, C]`` candidate-rank
    matrix (``retrieval.knn.rank_candidates`` output over
    ``evaluation.map.candidate_matrix`` layout: ``easy|hard|junk`` per row,
    classic ``ok|junk``) — the scale path: recall@k at 1M+ galleries without
    materializing any shortlist, since a query localizes@k iff its best
    positive's global rank < k.

    Junk images are NOT rank-shifted away (they hold real shortlist slots),
    matching ``localization_recall`` on the raw shortlist — the two agree
    exactly on the same ranking.
    """
    candidate_ranks = np.asarray(candidate_ranks)
    if candidate_ranks.shape[0] != len(gnd):
        raise ValueError(
            f"{candidate_ranks.shape[0]} rank rows vs {len(gnd)} gnd entries")
    ks = sorted(int(k) for k in ks)
    hits = {k: 0 for k in ks}
    n_eval = 0
    for i, g in enumerate(gnd):
        if "easy" in g or "hard" in g:
            ne, nh = len(g.get("easy", [])), len(g.get("hard", []))
            if protocol == "easy":
                sl = slice(0, ne)
            elif protocol == "medium":
                sl = slice(0, ne + nh)
            elif protocol == "hard":
                sl = slice(ne, ne + nh)
            else:
                raise ValueError(f"unknown protocol {protocol!r}")
        else:
            sl = slice(0, len(g.get("ok", [])))
        pos_ranks = candidate_ranks[i, sl]
        if pos_ranks.size == 0:
            continue
        n_eval += 1
        best = int(pos_ranks.min())
        for k in ks:
            if best < k:
                hits[k] += 1
    denom = max(n_eval, 1)
    return {
        "ks": ks,
        "recall": {k: hits[k] / denom for k in ks},
        "n_queries": n_eval,
    }


def localize_shortlist(
    index,
    qdescriptors: np.ndarray,
    query_names: Sequence[str],
    db_names: Optional[Sequence[str]] = None,
    k: int = 20,
    out_path: Optional[str] = None,
    qe_nqe: int = 0,
    qe_alpha: float = 3.0,
    diffusion: bool = False,
):
    """End to end: query the index (exact top-k), return (pairs, scores);
    optionally write the pairs file. ``db_names`` defaults to the index's
    stored ids, else the row numbers.

    ``qe_nqe`` (αQE, ``qe_alpha``) and ``diffusion`` re-rank before the top-k
    cut, as in the JAX package: a better shortlist for the same pose
    solver. With diffusion the scores are None (its ranks are not cosines).
    """
    if diffusion:
        idx = index.diffusion_ranks(qdescriptors, qe_nqe=qe_nqe, qe_alpha=qe_alpha)[:k].T
        scores = None
    else:
        scores, idx = index.query(qdescriptors, k=k, qe_nqe=qe_nqe, qe_alpha=qe_alpha)
    if db_names is None:
        if index.ids is None:
            db_names = [str(i) for i in range(index.gallery.shape[0])]
        else:
            db_names = [str(i) for i in index.ids]
    pairs = retrieval_pairs(query_names, db_names, idx)
    if out_path:
        write_pairs_file(out_path, query_names, db_names, idx)
    return pairs, scores
