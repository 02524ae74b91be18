"""Score matrix + per-block maxima: CUDA kernel, its plain version, and the
exact search built on it.

Replaces the JAX package's ``ops/pallas/score_topk.py::scores_blockmax``
(and ``pallas_topk_search``). The kernel is ``csrc/score_topk.cu``: bound by
its f32 FMA work, a tiled ``Q @ G.T`` whose epilogue sets the pad columns to
NEG_INF and takes the per-64-column block maxima while the tile is still in
registers (the fusion Mosaic refused on the TPU). Small batches take its
small-batch form, with the query tile and gallery splits of the fused top-k's
plan (``ops.kernels.fused_topk._plan``): the same scores bit for bit.

:func:`blockmax_topk_search` is the exact top-k on top of it, as
``pallas_topk_search``: the kernel is stage 1; stages 2-3
(:func:`blockmax_select`, which the ADC search shares) are plain tensor
code, as XLA ran them. The top ``kb = min(k, nb)`` blocks by maximum are
taken with a stable descending sort, re-sorted by block id, gathered, and a
stable sort of the candidates gives the top k. Each selected block holds an
element at least as good as every element of an unselected block, so the
candidates contain the top k; stable block selection keeps the
lowest-indexed of tying blocks, and the candidate row is index-ascending, so
ties go to the lower gallery index as in a stable argsort.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.fused_topk import (
    _BM,
    _plan,
    _sms,
)

BLOCK = 64  # columns per block maximum, csrc/score_topk.cu BLOCK
NEG_INF = float(torch.finfo(torch.float32).min)


def _check(gallery: torch.Tensor, queries: torch.Tensor) -> None:
    if gallery.dim() != 2 or queries.dim() != 2 or gallery.shape[1] != queries.shape[1]:
        raise ValueError(f"need gallery [Ng, D] and queries [Nq, D], got "
                         f"{tuple(gallery.shape)} and {tuple(queries.shape)}")
    if gallery.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gallery must be float32 or bfloat16, got {gallery.dtype}")
    if gallery.shape[0] == 0:
        raise ValueError("gallery is empty")


def scores_blockmax_plain(gallery: torch.Tensor,
                          queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: f32 scores padded to whole blocks with NEG_INF,
    then the block maxima."""
    _check(gallery, queries)
    Nq, Ng = queries.shape[0], gallery.shape[0]
    nb = -(-Ng // BLOCK)
    scores = torch.matmul(queries.float(), gallery.float().T)
    pad = nb * BLOCK - Ng
    if pad:
        scores = torch.cat([scores, torch.full((Nq, pad), NEG_INF, device=scores.device)], 1)
    return scores, scores.view(Nq, nb, BLOCK).amax(dim=-1)


def scores_blockmax(gallery: torch.Tensor,
                    queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scores = queries @ gallery.T`` in f32 plus per-64-column maxima.

    gallery: [Ng, D] f32 or bf16; queries: [Nq, D]. Returns (scores [Nq,
    Ng_pad] f32, bmax [Nq, Ng_pad / 64] f32), Ng_pad = 64 * ceil(Ng / 64);
    pad columns score NEG_INF. Queries are used in f32 as given (rounding
    them to the gallery dtype is the caller's choice, as in the JAX package).
    """
    if gallery.device.type == "cpu" and queries.device.type == "cpu":
        return scores_blockmax_plain(gallery, queries)
    if gallery.device.type != "cuda" or queries.device != gallery.device:
        raise ValueError(f"gallery and queries must be on one CUDA device, got "
                         f"{gallery.device} and {queries.device}")
    _check(gallery, queries)
    if not gallery.is_contiguous():
        raise ValueError("gallery must be contiguous")
    q = queries.float().contiguous()
    Nq, D = q.shape
    Ng = gallery.shape[0]
    ng_pad = BLOCK * -(-Ng // BLOCK)
    dev = gallery.device
    scores = torch.empty((Nq, ng_pad), dtype=torch.float32, device=dev)
    bmax = torch.empty((Nq, ng_pad // BLOCK), dtype=torch.float32, device=dev)
    if Nq == 0:
        return scores, bmax
    plan = _plan(Nq, Ng, _sms(dev.index))
    lib = _build.load("score_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scores_blockmax_forward(
            q.data_ptr(), gallery.data_ptr(), scores.data_ptr(), bmax.data_ptr(), Nq, Ng, D,
            ng_pad, int(gallery.dtype == torch.bfloat16), plan.width, plan.n_splits, stream)
    _build.check(err, "scores_blockmax_forward")
    scores_blockmax.launches += 1
    scores_blockmax.narrow_launches += plan.width < _BM
    return scores, bmax


def blockmax_select(scores: torch.Tensor, bmax: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 2-3 of the exact search on a padded score matrix and its
    block maxima (the output contract of :func:`scores_blockmax` and of
    ``ops.kernels.adc.adc_scores``): scores [Nq, nb * 64], bmax [Nq, nb].
    Returns (scores [Nq, k'] f32, columns [Nq, k'] int32), best first, ties
    lower column first, with k' = min(k, nb * 64)."""
    Nq, nb = bmax.shape
    kb = min(k, nb)
    order = torch.sort(bmax, dim=1, descending=True, stable=True).indices[:, :kb]
    bidx = torch.sort(order, dim=1).values                    # index-ascending gather
    cand = torch.gather(scores.view(Nq, nb, BLOCK), 1,
                        bidx[..., None].expand(Nq, kb, BLOCK)).reshape(Nq, kb * BLOCK)
    cidx = (bidx[..., None] * BLOCK
            + torch.arange(BLOCK, device=bidx.device)).reshape(Nq, kb * BLOCK)
    top, pos = torch.sort(cand, dim=1, descending=True, stable=True)
    return top[:, :k].contiguous(), torch.gather(cidx, 1, pos[:, :k]).to(torch.int32)


def blockmax_topk_search(gallery: torch.Tensor, queries: torch.Tensor,
                         k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k through :func:`scores_blockmax` (the counterpart of the
    JAX package's ``pallas_topk_search``). Returns (scores [Nq, k] f32,
    indices [Nq, k] int32), best first, ties lower-index first; k is
    clamped to the gallery size."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    scores, bmax = scores_blockmax(gallery, queries)
    return blockmax_select(scores, bmax, min(k, gallery.shape[0]))


scores_blockmax.launches = 0
scores_blockmax.narrow_launches = 0  # of them, the small-batch form
