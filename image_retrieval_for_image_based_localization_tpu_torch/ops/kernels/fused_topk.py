"""Exact top-k search with no score matrix: CUDA kernel and its plain version.

Replaces the JAX package's ``ops/pallas/fused_topk.py::fused_topk_search``.
The kernel is ``csrc/fused_topk.cu``: bound by its f32 FMA work, it scores
128-row gallery tiles against a tile of 128 queries on the register-blocked
mainloop of ``csrc/sgemm_tile.cuh`` and keeps each query's running top-k
sorted in shared memory, taking only the scores that beat a query's k-th
entry out of registers. The gallery is split into runs of whole tiles
across blocks to fill the card (:func:`_plan`), and a second pass merges the
splits' lists. Results follow the strict order (score desc, index asc),
so ties go to the lower gallery index, as ``retrieval.knn`` promises.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build

LANES = 128   # largest k, as on the TPU
_BM = 128     # queries per block of the first pass, csrc/sgemm_tile.cuh BM
_BN = 128     # gallery rows per tile, csrc/sgemm_tile.cuh BN


def _plan(nq: int, ng: int, sms: int) -> Tuple[int, int]:
    """Grid of the first pass: ``(q_tiles, n_splits)``.

    A first-pass block fills an SM (512 threads at 128 registers each), so
    query tiles times gallery splits fill the ``sms`` SMs where the shape
    allows it; a split is never empty, so there are at most as many splits
    as gallery tiles. :func:`_split_rows` gives each split's rows, the same
    formula as the kernel's ``split_tiles``."""
    q_tiles = -(-nq // _BM)
    g_tiles = -(-ng // _BN)
    n_splits = max(1, min(g_tiles, -(-sms // q_tiles)))
    return q_tiles, n_splits


def _split_rows(split: int, n_splits: int, ng: int) -> Tuple[int, int]:
    """Gallery rows ``[start, end)`` of a split: a balanced partition of the
    ``ceil(ng / 128)`` whole tiles, so every split starts on a tile."""
    g_tiles = -(-ng // _BN)
    t0 = split * g_tiles // n_splits
    t1 = (split + 1) * g_tiles // n_splits
    return t0 * _BN, min(ng, t1 * _BN)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _prepare(gallery: torch.Tensor, queries: torch.Tensor, k: int):
    if k > LANES:
        raise ValueError(f"fused_topk_search supports k <= {LANES}, got {k}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if gallery.dim() != 2 or queries.dim() != 2 or gallery.shape[1] != queries.shape[1]:
        raise ValueError(f"need gallery [Ng, D] and queries [Nq, D], got "
                         f"{tuple(gallery.shape)} and {tuple(queries.shape)}")
    if gallery.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gallery must be float32 or bfloat16, got {gallery.dtype}")
    if gallery.shape[0] == 0:
        raise ValueError("gallery is empty")
    k = min(k, gallery.shape[0])  # never return pad sentinels
    # queries are rounded to the gallery dtype first, as the TPU kernel does
    q = queries.to(gallery.dtype).float()
    return q, k


def fused_topk_plain(gallery: torch.Tensor, queries: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: f32 scores, then a stable descending sort
    (equal scores keep index order, so the lower index wins). On the CPU
    the scores come from ``retrieval.knn``'s fixed tiles, so a query gets
    the same bits in any batch, as it does from the kernel (serving's
    micro-batches rely on it)."""
    q, k = _prepare(gallery, queries, k)
    if gallery.device.type == "cpu":
        from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
            _tiled_scores,
        )

        scores = _tiled_scores(gallery, q)
    else:
        scores = torch.matmul(q, gallery.float().T)
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def fused_topk_search(gallery: torch.Tensor, queries: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k search, scores never materialized, for ``k <= 128``.

    gallery: [Ng, D] f32 or bf16; queries: [Nq, D]. Returns (scores [Nq, k]
    f32, indices [Nq, k] int32), best first, ties lower-index first.
    """
    if gallery.device.type == "cpu" and queries.device.type == "cpu":
        return fused_topk_plain(gallery, queries, k)
    if gallery.device.type != "cuda" or queries.device != gallery.device:
        raise ValueError(f"gallery and queries must be on one CUDA device, got "
                         f"{gallery.device} and {queries.device}")
    q, k = _prepare(gallery, queries, k)
    if not gallery.is_contiguous():
        raise ValueError("gallery must be contiguous")
    q = q.contiguous()
    Nq, D = q.shape
    Ng = gallery.shape[0]
    dev = gallery.device
    if Nq == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    _, n_splits = _plan(Nq, Ng, _sms(dev.index))
    part_v = torch.empty((Nq, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Nq, n_splits, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((Nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Nq, k), dtype=torch.int32, device=dev)
    lib = _build.load("fused_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_topk_forward(
            q.data_ptr(), gallery.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), Nq, Ng, D, k, n_splits,
            int(gallery.dtype == torch.bfloat16), stream)
    _build.check(err, "fused_topk_forward")
    fused_topk_search.launches += 1
    return out_v, out_i


fused_topk_search.launches = 0
