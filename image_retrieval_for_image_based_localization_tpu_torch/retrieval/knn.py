"""Exact brute-force kNN over a descriptor gallery (one device, or one
shard of a row-sharded gallery).

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

Both cores are shard-safe, as the JAX package's: ``n_valid`` masks pad rows
at a shard's end and ``index_offset`` maps local rows to global ones
(``parallel.sharded_index``). A shard's scores must be the bits one device
computes for the same (query, row) pair, or a planted tie across a shard
border breaks. Kernel B3 keeps one FMA order per pair whatever the shapes,
so on the card the search scores f32 and bf16 through it, and so do
sharded candidate ranks; cuBLAS and CPU ``torch.matmul`` round
differently for other matrix shapes, so the CPU scores fixed, zero-padded
tiles (:func:`_tiled_scores`). Single-device candidate ranks on the card
keep the cuBLAS scoring they had before sharding (one device has no shard
border to agree across), so they stay held against an independent cuBLAS
ranking; sharded ranks pass ``stable``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (
    blockmax_topk_search,
    scores_blockmax,
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


# CPU score tiles: queries x gallery rows per torch.mm
_TILE_Q, _TILE_G = 64, 4096


def _tiled_scores(gallery: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """:func:`score_matrix` on the CPU from fixed ``[64, D] x [D, 4096]``
    products on zero-padded tiles, so a (query, row) pair gets the same bits
    whatever the batch's and the gallery's sizes, as kernel B3 gives on the
    card: a row scored in its shard equals the row scored in the whole
    gallery, and a block of queries equals the whole batch. (One batched
    ``torch.matmul`` over the tiles is not enough: MKL's batched product
    rounds differently for another batch count.)"""
    Nq, Ng = queries.shape[0], gallery.shape[0]
    q = queries.float() if gallery.dtype == torch.int8 else queries.to(gallery.dtype).float()
    if Nq % _TILE_Q:
        q = F.pad(q, (0, 0, 0, -Nq % _TILE_Q))
    out = torch.empty((q.shape[0], Ng + (-Ng % _TILE_G)), dtype=torch.float32)
    for j in range(0, Ng, _TILE_G):
        g = gallery[j : j + _TILE_G].float()
        if g.shape[0] < _TILE_G:
            g = F.pad(g, (0, 0, 0, _TILE_G - g.shape[0]))
        for i in range(0, q.shape[0], _TILE_Q):
            torch.mm(q[i : i + _TILE_Q], g.T, out=out[i : i + _TILE_Q, j : j + _TILE_G])
    out = out[:Nq, :Ng]
    return out * (1.0 / 127.0) if gallery.dtype == torch.int8 else out


def _dense_scores(gallery: torch.Tensor, queries: torch.Tensor,
                  stable: bool = False) -> torch.Tensor:
    """:func:`score_matrix`'s values, tiled on the CPU (the same bits for a
    (query, row) pair whatever the shapes). On the card cuBLAS, or with
    ``stable`` kernel B3 for an f32 or bf16 gallery, which keeps those bits
    at any shape where cuBLAS picks other algorithms for other shapes (int8,
    which B3 does not take, stays on cuBLAS)."""
    if gallery.device.type == "cpu":
        return _tiled_scores(gallery, queries)
    if stable and gallery.dtype in (torch.float32, torch.bfloat16):
        return scores_blockmax(gallery, queries.to(gallery.dtype).float())[0][:, : gallery.shape[0]]
    return score_matrix(gallery, queries)


def knn_search(
    gallery: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    chunk: Optional[int] = None,
    n_valid: Optional[int] = None,
    index_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over gallery chunks: ``(scores [Nq,k] f32, indices [Nq,k] int32)``.

    A chunk's candidates are either its whole score row (dense route) or its
    own exact top-k in (score desc, index asc) order (block-max route, CUDA
    f32/bf16). The carried top-k sits in front of them and its indices are
    all lower, so a stable sort of the concatenation keeps lower-index-wins.

    Shard-safe: only rows ``< n_valid`` are scored (default: all), and the
    result always has ``min(k, Ng)`` columns; columns past the valid rows
    score NEG_INF with row INT32_MAX, as pad rows of a shard do in the JAX
    package's ``streaming_topk``. Indices are ``index_offset`` + local row.
    """
    Ng = gallery.shape[0]
    Nq = queries.shape[0]
    k_out = min(k, Ng)
    n_valid = Ng if n_valid is None else max(0, min(int(n_valid), Ng))
    k = min(k, n_valid)
    best_s = torch.full((Nq, 0), NEG_INF, dtype=torch.float32, device=gallery.device)
    best_i = torch.full((Nq, 0), INT32_MAX, dtype=torch.int64, device=gallery.device)
    if k > 0:
        chunk = min(chunk or auto_chunk(Ng, Nq), n_valid)
        blockmax = gallery.device.type == "cuda" and gallery.dtype in (torch.float32,
                                                                       torch.bfloat16)
        if blockmax:
            queries = queries.to(gallery.dtype).float()  # as score_matrix rounds them
        for start in range(0, n_valid, chunk):
            stop = min(start + chunk, n_valid)
            if blockmax:
                s, ids = blockmax_topk_search(gallery[start:stop], queries, k)
                ids = ids.to(torch.int64) + start
            else:
                s = _dense_scores(gallery[start:stop], queries)
                ids = torch.arange(start, stop, device=s.device, dtype=torch.int64).expand(Nq, -1)
            best_s, best_i = merge_topk(torch.cat([best_s, s], dim=1),
                                        torch.cat([best_i, ids], dim=1), k)
        best_i = best_i + index_offset
    if k_out > k:
        best_s = torch.cat([best_s, best_s.new_full((Nq, k_out - k), NEG_INF)], dim=1)
        best_i = torch.cat([best_i, best_i.new_full((Nq, k_out - k), INT32_MAX)], dim=1)
    return best_s.contiguous(), best_i.to(torch.int32).contiguous()


def approx_topk(
    gallery: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    recall_target: float = 0.95,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``approx_topk``: ``lax.approx_max_k``, the TPU's
    partial-reduction selection at ``recall_target``. On CPU and GPU XLA
    lowers it to an exact top-k, and so does the port: this is
    :func:`knn_search` (recall 1.0, which meets any target), so its order on
    ties is the exact search's, lower row first. Returns ``(scores [Nq, k]
    f32, indices [Nq, k] int32)``."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
    return knn_search(torch.as_tensor(gallery), torch.as_tensor(queries), k, chunk=chunk)


def full_ranks(gallery: torch.Tensor, queries: torch.Tensor, batch: int = 256) -> np.ndarray:
    """Full ranking ``[Ng, Nq]`` for mAP: dense scores, then a descending
    stable sort per query (the JAX package's host argsort, same order)."""
    ranks = []
    for s in range(0, queries.shape[0], batch):
        scores = score_matrix(gallery, queries[s : s + batch])  # [b, Ng]
        order = torch.sort(scores, dim=1, descending=True, stable=True).indices
        ranks.append(order.T.cpu().numpy())
    return np.concatenate(ranks, axis=1)


def _candidate_scores(gallery, queries, cand, chunk, index_offset, stable) -> torch.Tensor:
    """Pass 1 of :func:`rank_candidates_core`: each candidate's own score,
    read out of the chunk's score block that holds its row; 0 where this
    gallery (shard) does not hold it."""
    Ng = gallery.shape[0]
    Nq, C = cand.shape
    cs = torch.zeros((Nq, C), dtype=torch.float32, device=gallery.device)
    local = cand - index_offset
    for start in range(0, Ng, chunk):
        s = _dense_scores(gallery[start : start + chunk], queries, stable)  # [Nq, n]
        lc = local - start
        inb = (lc >= 0) & (lc < s.shape[1])
        g = torch.gather(s, 1, torch.clamp(lc, 0, s.shape[1] - 1))
        cs = torch.where(inb, g, cs)
    return cs


def _count_ahead(gallery, queries, cand, cs, chunk, n_valid, index_offset,
                 stable) -> torch.Tensor:
    """Pass 2 of :func:`rank_candidates_core`: per candidate, the valid rows
    of this gallery (shard) that rank ahead of it. It scores the chunks of
    pass 1, pad rows included, so each score is the same product's bits."""
    Nq, C = cand.shape
    counts = torch.zeros((Nq, C), dtype=torch.int64, device=gallery.device)
    for start in range(0, n_valid, chunk):
        s = _dense_scores(gallery[start : start + chunk], queries, stable)  # [Nq, n]
        lidx = torch.arange(start, start + s.shape[1], device=s.device)
        s3, c3 = s[:, :, None], cs[:, None, :]
        ahead = (s3 > c3) | ((s3 == c3) & (lidx[None, :, None] + index_offset
                                          < cand[:, None, :]))
        counts += (ahead & (lidx < n_valid)[None, :, None]).sum(dim=1)
    return counts


def rank_candidates_core(
    gallery,
    queries: torch.Tensor,
    cand: torch.Tensor,
    chunk: Optional[int] = None,
    n_valid=None,
    index_offset=0,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    stable: bool = False,
) -> torch.Tensor:
    """Global 0-based rank of each candidate gallery row, by streaming count
    (the JAX package's ``rank_candidates_core``).

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

    Shard-safe: ``gallery`` is one tensor, or a sequence of this process's
    local shards with ``n_valid`` and ``index_offset`` as sequences beside
    it. The shards' partials (candidate scores, then counts) are summed in
    order on the queries' device, then ``reduce`` runs on each sum: the
    sharded path passes ``dist.all_reduce(SUM)`` over the process group,
    the JAX package's psum. Exactly one shard holds a candidate's row, the
    others add literal zeros, so the summed scores are exact. The sharded
    path also passes ``stable``: on the card each shard then scores through
    kernel B3, so its ranks are those of one device's B3 scores bit for bit
    (cuBLAS at a shard's shape can round a row otherwise than at the whole
    gallery's, and a near tie then ranks the other way).

    Args:
      gallery: [Ng, D] f32, bf16 or int8 (as ``score_matrix`` takes it), or
        a sequence of such shards.
      queries: [Nq, D] f32.
      cand: [Nq, C] integer *global* gallery rows (pad with any valid row
        and ignore its output).
    Returns: [Nq, C] int32 ranks.
    """
    if isinstance(gallery, torch.Tensor):
        gallery, n_valid, index_offset = [gallery], [n_valid], [index_offset]
    shards = [(g, g.shape[0] if nv is None else max(0, min(int(nv), g.shape[0])), int(off))
              for g, nv, off in zip(gallery, n_valid, index_offset)]
    Nq, C = cand.shape
    out = queries.device
    cand = torch.as_tensor(cand).to(out, torch.int64)

    def chunk_of(Ng):
        if chunk is not None:
            return max(1, min(chunk, Ng))
        c = max(512, 32 * 1024 * 1024 // max(Nq * C, 1))
        return max(1, min(-(-c // 128) * 128, Ng))

    def on(g):
        return queries.to(g.device), cand.to(g.device)

    cs = sum(_candidate_scores(g, *on(g), chunk_of(g.shape[0]), off, stable).to(out)
             for g, _, off in shards)
    if reduce is not None:
        cs = reduce(cs)
    counts = sum(_count_ahead(g, *on(g), cs.to(g.device), chunk_of(g.shape[0]), nv, off,
                              stable).to(out)
                 for g, nv, off in shards)
    if reduce is not None:
        counts = reduce(counts)
    return counts.to(torch.int32)


def rank_candidates(
    gallery: torch.Tensor,
    queries: torch.Tensor,
    cand: torch.Tensor,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Single-device entry for :func:`rank_candidates_core` (see there)."""
    return rank_candidates_core(gallery, queries, cand, chunk=chunk)
