"""Exact brute-force kNN over a descriptor gallery (one device).

The JAX package's ``retrieval/knn.py``: scores are ``queries @ gallery.T``
in f32, and on exact ties the lower gallery index wins, matching NumPy
``argsort(-scores, kind='stable')``. Selection is stable throughout
(``torch.topk`` promises no order among equal values).

:func:`knn_search` streams gallery chunks and carries the running top-k. On
a CUDA f32 or bf16 gallery each chunk goes through the hand-written
score/block-max kernel and the exact block-max selection
(``ops.kernels.score_topk``, the JAX package's ``streaming_topk`` with
``blockmax_topk``); int8 storage and CPU tensors take dense scores and a
stable sort. The kernel ``ops.kernels.fused_topk`` covers k <= 128 without
a score matrix.

:func:`rank_candidates` gives the global rank of chosen gallery rows by
streaming counts over the gallery (no ``[Ng, Nq]`` ranking), for mAP on
large galleries.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (
    blockmax_topk_search,
)

NEG_INF = float(np.finfo(np.float32).min)
INT32_MAX = int(np.iinfo(np.int32).max)  # row sentinel of pad slots on the device


def sanitize_fill_rows(scores, rows) -> np.ndarray:
    """Host-boundary fill contract: slots that never matched a real gallery
    row (score NEG_INF; real scores are finite) return row -1, never a
    fabricated id. The IVF family can under-fill when k exceeds the probed
    rows."""
    scores = np.asarray(scores)
    return np.where(scores <= NEG_INF / 2, -1, np.asarray(rows))


def score_matrix(gallery: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Dense similarity scores ``[Nq, Ng]`` in f32.

    int8 storage (symmetric /127 quantization of unit-norm rows) is
    dequantized and rescaled to the cosine range; for a bf16 gallery the
    queries are rounded to bf16 first and the exact bf16 products are summed
    in f32 (the JAX package's ``preferred_element_type=f32``).
    """
    if gallery.dtype == torch.int8:
        return torch.matmul(queries.float(), gallery.float().T) * (1.0 / 127.0)
    q = queries.to(gallery.dtype).float()
    return torch.matmul(q, gallery.float().T)


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, equal values in index order (``lax.top_k``)."""
    top, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return top[..., :k], pos[..., :k]


def merge_topk(scores: torch.Tensor, idx: torch.Tensor, k: int):
    """Top-k of each row by score with their ids; equal scores keep their
    order in the row, so candidate lists laid out in ascending id order
    merge with lower-id-wins (the JAX package's ``merge_topk``)."""
    top, pos = stable_topk(scores, k)
    return top, torch.gather(idx, 1, pos)


def auto_chunk(Ng: int, Nq: int, budget_bytes: int = 256 * 1024 * 1024) -> int:
    """Largest gallery chunk whose score block [Nq, chunk] fits the budget."""
    chunk = budget_bytes // (max(Nq, 1) * 4)
    chunk = max(16384, (chunk // 128) * 128)
    return min(Ng, chunk)


def knn_search(
    gallery: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over gallery chunks: ``(scores [Nq,k] f32, indices [Nq,k] int32)``.

    A chunk's candidates are either its whole score row (dense route) or its
    own exact top-k in (score desc, index asc) order (block-max route, CUDA
    f32/bf16). The carried top-k sits in front of them and its indices are
    all lower, so a stable sort of the concatenation keeps lower-index-wins.
    """
    Ng = gallery.shape[0]
    Nq = queries.shape[0]
    k = min(k, Ng)
    chunk = min(chunk or auto_chunk(Ng, Nq), Ng)
    blockmax = gallery.device.type == "cuda" and gallery.dtype in (torch.float32,
                                                                   torch.bfloat16)
    if blockmax:
        queries = queries.to(gallery.dtype).float()  # as score_matrix rounds them
    best_s = best_i = None
    for start in range(0, Ng, chunk):
        if blockmax:
            s, ids = blockmax_topk_search(gallery[start : start + chunk], queries, k)
            ids = ids.to(torch.int64) + start
        else:
            s = score_matrix(gallery[start : start + chunk], queries)
            ids = torch.arange(start, start + s.shape[1], device=s.device,
                               dtype=torch.int64).expand(Nq, -1)
        if best_s is not None:
            s = torch.cat([best_s, s], dim=1)
            ids = torch.cat([best_i, ids], dim=1)
        best_s, best_i = merge_topk(s, ids, k)
    return best_s.contiguous(), best_i.to(torch.int32).contiguous()


def full_ranks(gallery: torch.Tensor, queries: torch.Tensor, batch: int = 256) -> np.ndarray:
    """Full ranking ``[Ng, Nq]`` for mAP: dense scores, then a descending
    stable sort per query (the JAX package's host argsort, same order)."""
    ranks = []
    for s in range(0, queries.shape[0], batch):
        scores = score_matrix(gallery, queries[s : s + batch])  # [b, Ng]
        order = torch.sort(scores, dim=1, descending=True, stable=True).indices
        ranks.append(order.T.cpu().numpy())
    return np.concatenate(ranks, axis=1)


def rank_candidates_core(
    gallery: torch.Tensor,
    queries: torch.Tensor,
    cand: torch.Tensor,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Global 0-based rank of each candidate gallery row, by streaming count
    (the JAX package's single-device ``rank_candidates_core``).

    Under the descending stable order (lower index first on ties) a
    candidate's rank is a count::

        rank(c) = #{g : s_g > s_c} + #{g : s_g == s_c and g < c}

    Two passes over the same gallery chunks: the first reads the
    candidates' own scores out of each chunk's score block, the second
    counts. Both score every chunk with the same shapes, so a candidate's
    score is the very bits it is compared with and the count keeps NumPy's
    ``argsort(kind='stable')`` order exactly. Plain torch on the gallery's
    device; the chunk bounds the ``[Nq, chunk, C]`` compare to 32 Mi
    elements by default.

    Args:
      gallery: [Ng, D] f32, bf16 or int8 (as ``score_matrix`` takes it).
      queries: [Nq, D] f32.
      cand: [Nq, C] integer gallery rows (pad with any valid row and ignore
        its output).
    Returns: [Nq, C] int32 ranks.
    """
    Ng = gallery.shape[0]
    Nq, C = cand.shape
    if chunk is None:
        budget_elems = 32 * 1024 * 1024
        chunk = max(512, budget_elems // max(Nq * C, 1))
        chunk = -(-chunk // 128) * 128
    chunk = min(chunk, Ng)
    dev = gallery.device
    queries = queries.to(dev)
    cand = torch.as_tensor(cand).to(dev, torch.int64)
    starts = range(0, Ng, chunk)

    cs = torch.zeros((Nq, C), dtype=torch.float32, device=dev)
    for start in starts:
        s = score_matrix(gallery[start : start + chunk], queries)  # [Nq, n]
        lc = cand - start
        inb = (lc >= 0) & (lc < s.shape[1])
        g = torch.gather(s, 1, torch.clamp(lc, 0, s.shape[1] - 1))
        cs = torch.where(inb, g, cs)

    counts = torch.zeros((Nq, C), dtype=torch.int64, device=dev)
    for start in starts:
        s = score_matrix(gallery[start : start + chunk], queries)  # [Nq, n]
        gidx = torch.arange(start, start + s.shape[1], device=dev)
        s3, c3 = s[:, :, None], cs[:, None, :]
        ahead = (s3 > c3) | ((s3 == c3) & (gidx[None, :, None] < cand[:, None, :]))
        counts += ahead.sum(dim=1)
    return counts.to(torch.int32)


def rank_candidates(
    gallery: torch.Tensor,
    queries: torch.Tensor,
    cand: torch.Tensor,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Single-device entry for :func:`rank_candidates_core` (see there)."""
    return rank_candidates_core(gallery, queries, cand, chunk=chunk)
