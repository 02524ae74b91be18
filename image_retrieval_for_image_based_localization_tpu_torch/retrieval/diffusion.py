"""Diffusion re-ranking on the gallery's kNN graph: the JAX package's
``retrieval/diffusion.py`` (Iscen et al., CVPR 2017).

A symmetric, degree-normalized affinity graph is built over the gallery
once; each query is seeded at its strongest gallery matches, and
``(I - alpha S) f = y`` is solved for the relevance ``f``, so scores flow
along chains of similar rows.

- The graph: one exact kNN pass of the gallery against itself
  (``knn.knn_search``, kernel B3 on the card) in blocks of
  :data:`GRAPH_BLOCK` rows, weights ``max(s, 0)^gamma``; self-edges are
  dropped by identity, not by position (with duplicate rows a row's first
  neighbour need not be itself); each edge and its reverse, so mutual
  edges count twice; ``S = D^-1/2 A_sym D^-1/2``.
- The edges are sorted by destination once, when the graph is built, and
  every sum over a destination's edges is ``torch.segment_reduce`` over
  that order: one thread sums a segment sequentially, so two calls give
  the same bits on the card, where ``index_add_`` would sum with atomics
  in any order and re-order near-ties. (The JAX package skips the sort;
  it found no speed gain on the TPU for 15 s of build.)
- The solver: conjugate gradient with a fixed number of iterations, the
  JAX package's 1e-20 guards; queries are columns of one ``[N, Nq]``
  solve.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import knn_search

# query rows of the graph's kNN pass at a time (bounds its score blocks)
GRAPH_BLOCK = 8192


class DiffusionGraph(NamedTuple):
    """Symmetric normalized affinity graph as an edge list sorted by
    destination: ``src``/``dst`` [E] int64 (E = 2 N k: the kNN edges and
    their reverses), ``w`` [E] f32 entries of ``D^-1/2 A_sym D^-1/2``,
    ``offsets`` [N + 1] where each destination's edges start, ``n`` rows."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    offsets: torch.Tensor
    n: int


def _segment_sum(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Sum of ``values`` [E, ...] over each destination's run of edges."""
    return torch.segment_reduce(values, "sum", offsets=offsets, axis=0)


def build_graph(gallery: torch.Tensor, k: int = 50, gamma: float = 3.0) -> DiffusionGraph:
    """kNN affinity graph over the gallery (on its device), symmetrized and
    normalized: ``A = max(s, 0)^gamma`` on each row's top-k (self-edge
    dropped), ``A_sym = A + A^T``, ``S = D^-1/2 A_sym D^-1/2``."""
    n = int(gallery.shape[0])
    kk = min(k + 1, n)  # +1: each row's list holds the row itself
    s_blocks, i_blocks = [], []
    for start in range(0, n, GRAPH_BLOCK):
        s, i = knn_search(gallery, gallery[start : start + GRAPH_BLOCK].float(), k=kk)
        s_blocks.append(s)
        i_blocks.append(i.to(torch.int64))
    return graph_from_knn(torch.cat(s_blocks), torch.cat(i_blocks), gamma)


def graph_from_knn(scores: torch.Tensor, idx: torch.Tensor, gamma: float = 3.0) -> DiffusionGraph:
    """:func:`build_graph` from each row's kNN list (``scores``, ``idx``
    [N, k + 1], row ``r``'s list on row ``r``), on their device."""
    n = int(idx.shape[0])
    kk = int(idx.shape[1])
    dev = idx.device
    idx = idx.to(torch.int64)
    w = torch.clamp(scores, min=0.0) ** float(gamma)
    rows = torch.arange(n, device=dev)
    # by identity: a zero-weight edge adds nothing to degrees or products
    w = torch.where(idx == rows[:, None], torch.zeros_like(w), w)
    src = torch.cat([rows.repeat_interleave(kk), idx.reshape(-1)])
    dst = torch.cat([idx.reshape(-1), rows.repeat_interleave(kk)])
    ww = torch.cat([w.reshape(-1), w.reshape(-1)])
    order = torch.sort(dst, stable=True).indices
    src, dst, ww = src[order], dst[order], ww[order]
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(dst, minlength=n), 0)
    deg = _segment_sum(ww, offsets)
    dinv = torch.rsqrt(torch.clamp(deg, min=1e-12))
    return DiffusionGraph(src=src, dst=dst, w=ww * dinv[src] * dinv[dst], offsets=offsets, n=n)


def _matvec(graph: DiffusionGraph, F: torch.Tensor) -> torch.Tensor:
    """``S @ F`` for ``F`` [N, Nq]: gather the sources, sum per destination."""
    return _segment_sum(graph.w[:, None] * F[graph.src], graph.offsets)


def diffuse(graph: DiffusionGraph, seeds: torch.Tensor, alpha: float = 0.9,
            iters: int = 30) -> torch.Tensor:
    """Solve ``(I - alpha S) F = seeds`` by fixed-iteration CG; ``seeds``
    [N, Nq], one column a query. Returns the relevance [N, Nq] f32.

    ``alpha=0.9``, not the paper's 0.99, as in the JAX package: diffusing
    the whole graph at 0.99 drifts toward the degree distribution (there:
    mAP 0.64 at 0.9 against 0.37 at 0.99 on its clustered corpus)."""
    y = seeds.float()
    a = float(alpha)
    x = torch.zeros_like(y)
    r = y
    p = r
    rs = torch.sum(r * r, dim=0)
    for _ in range(iters):
        Ap = p - a * _matvec(graph, p)
        ak = rs / torch.clamp(torch.sum(p * Ap, dim=0), min=1e-20)
        x = x + ak[None, :] * p
        r = r - ak[None, :] * Ap
        rs_new = torch.sum(r * r, dim=0)
        p = r + (rs_new / torch.clamp(rs, min=1e-20))[None, :] * p
        rs = rs_new
    return x


def diffusion_scores(gallery: torch.Tensor, queries: torch.Tensor,
                     graph: Optional[DiffusionGraph] = None, k_graph: int = 50,
                     k_seed: int = 10, gamma: float = 3.0, alpha: float = 0.9,
                     iters: int = 30) -> np.ndarray:
    """Diffusion relevance ``[N, Nq]`` (numpy). Seeds are each query's top
    ``k_seed`` gallery matches at weight ``max(s, 0)^gamma``; pass a built
    ``graph`` to reuse it across query batches."""
    if graph is None:
        graph = build_graph(gallery, k=k_graph, gamma=gamma)
    s, idx = knn_search(gallery, queries.to(gallery.device).float(), k=min(k_seed, graph.n))
    return diffuse(graph, seed_matrix(s, idx, graph.n, gamma), alpha=alpha,
                   iters=iters).cpu().numpy()


def seed_matrix(scores: torch.Tensor, idx: torch.Tensor, n: int, gamma: float = 3.0):
    """Seeds ``[n, Nq]`` from each query's top matches (``scores``, ``idx``
    [Nq, k_seed]): ``max(s, 0)^gamma`` at the matched rows, 0 elsewhere."""
    nq, ks = idx.shape
    seeds = torch.zeros((n, nq), dtype=torch.float32, device=scores.device)
    # a query's matches are distinct rows, so each (row, query) is set once
    seeds[idx.reshape(-1).long(), torch.arange(nq, device=seeds.device).repeat_interleave(ks)] = (
        torch.clamp(scores, min=0.0).reshape(-1) ** float(gamma))
    return seeds
