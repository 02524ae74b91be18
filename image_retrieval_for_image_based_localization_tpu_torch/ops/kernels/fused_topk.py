"""Exact top-k search with no score matrix: CUDA kernel and its plain version.

Replaces the JAX package's ``ops/pallas/fused_topk.py::fused_topk_search``.
The kernel is ``csrc/fused_topk.cu``: bound by its f32 FMA work, it scores
128-row gallery tiles against a tile of 128 queries on the register-blocked
mainloop of ``csrc/sgemm_tile.cuh`` and keeps each query's running top-k
sorted in shared memory, taking only the scores that beat a query's k-th
entry out of registers. Small batches (Nq up to :data:`NARROW_MAX_NQ`) take
its small-batch form instead: a query tile of Nq rounded up to 8 (at most
32) against 1,024-row gallery tiles streamed by TMA
(``csrc/narrow_tile.cuh``), every score the same ``fmaf`` chain, so a query
gets the same bits in either form. The gallery is split into runs of whole
tiles (the small-batch form: of 256 rows) across blocks to fill the card
(:func:`_plan`), and a second pass merges the splits' lists. Results follow the strict order (score desc,
index asc), so ties go to the lower gallery index, as ``retrieval.knn``
promises.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build

LANES = 128   # largest k, as on the TPU
_BM = 128     # queries per block of the first pass, csrc/sgemm_tile.cuh BM
_BN = 128     # gallery rows per tile, csrc/sgemm_tile.cuh BN
NARROW_WIDTHS = (8, 16, 24, 32)  # small-batch query tiles, csrc/narrow_tile.cuh MAX_NQ
_NARROW_UNIT = 256  # gallery rows of a small-batch split's unit, csrc/narrow_tile.cuh BOX_ROWS
# The cutover: up to this many queries take the small-batch form (query
# tiles of min(32, Nq rounded up to 8)), above it the 128-row form. Where
# it lies was measured (``tools/search_kernel_bench.py --small-batch``, an
# H100 80GB HBM3 at 700 W, ms through the wrapper, small-batch against
# 128-row): at 33 and 64 queries over 1M x 2048 bf16, scores_blockmax 6.02
# and 5.95 against 11.47 and 11.29, fused_topk_search (k=100) 7.28 and 7.49
# against 12.22 and 12.26; over 100k x 2048 f32, 0.954 and 0.990 against
# 1.205 and 1.185, and 1.403 and 1.353 against 1.440 and 1.460. At 96 the
# 100k f32 gallery went the other way (1.426 against 1.202, 1.901 against
# 1.610), so the cutover stays at 64.
NARROW_MAX_NQ = 64


class Plan(NamedTuple):
    """A launch of either exact-search kernel: the query tile's rows
    (``width``: 8, 16, 24, 32 for the small-batch form, 128 for the 128-row
    form), query tiles, the gallery rows a split is made of whole runs of
    (``split_rows``: 256, or the 128-row form's tile), and gallery splits."""

    width: int
    q_tiles: int
    split_rows: int
    n_splits: int


def _plan(nq: int, ng: int, sms: int) -> Plan:
    """The query tile and the grid of both exact-search kernels.

    Up to :data:`NARROW_MAX_NQ` queries the query tile is Nq rounded up to
    8, at most 32 (the TPU kernel's rule, ``-(-Nq // 8) * 8``), and a split
    is whole runs of 256 rows, walked in 1,024-row tiles; above it 128
    queries against 128-row tiles, a split whole tiles. A block fills an
    SM, so query tiles times gallery splits fill the ``sms`` SMs where the
    shape allows it; a split is never empty, so there are at most as many
    splits as runs. :func:`_split_rows` gives each split's rows, the same
    formula as the kernels' ``split_rows`` and ``split_tiles``."""
    if nq <= NARROW_MAX_NQ:
        width, split_rows = min(NARROW_WIDTHS[-1], -(-nq // 8) * 8), _NARROW_UNIT
    else:
        width, split_rows = _BM, _BN
    q_tiles = -(-nq // width)
    units = -(-ng // split_rows)
    n_splits = max(1, min(units, -(-sms // q_tiles)))
    return Plan(width, q_tiles, split_rows, n_splits)


def _split_rows(split: int, n_splits: int, ng: int, split_rows: int = _BN) -> Tuple[int, int]:
    """Gallery rows ``[start, end)`` of a split: a balanced partition of the
    ``ceil(ng / split_rows)`` whole runs, so every split starts on a run."""
    units = -(-ng // split_rows)
    u0 = split * units // n_splits
    u1 = (split + 1) * units // n_splits
    return u0 * split_rows, min(ng, u1 * split_rows)


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
    plan = _plan(Nq, Ng, _sms(dev.index))
    n_splits = plan.n_splits
    part_v = torch.empty((Nq, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Nq, n_splits, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((Nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Nq, k), dtype=torch.int32, device=dev)
    lib = _build.load("fused_topk")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_topk_forward(
            q.data_ptr(), gallery.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), Nq, Ng, D, k, plan.width, n_splits,
            int(gallery.dtype == torch.bfloat16), stream)
    _build.check(err, "fused_topk_forward")
    fused_topk_search.launches += 1
    fused_topk_search.narrow_launches += plan.width < _BM
    return out_v, out_i


fused_topk_search.launches = 0
fused_topk_search.narrow_launches = 0  # of them, the small-batch form
