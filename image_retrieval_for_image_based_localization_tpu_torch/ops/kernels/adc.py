"""PQ asymmetric-distance scores + per-block maxima: CUDA kernel and its
plain version.

Replaces the JAX package's ``ops/pallas/adc_mxu.py::adc_scores_mxu`` (with
``prepare_lut_tables``). The kernel is ``csrc/adc.cu``: bound by its
shared-memory lookups, a block stages ``QB`` queries' LUTs in shared memory
interleaved (entry (m, code) one float4 at QB = 4, in 64 KB slices of
subquantizers), so one vector load makes QB lookups, and scores rows as the
exact f32 gather ``score[q, r] = sum_m lut[q, m, codes[r, m]]``, one
sequential sum over m for each query.
Its output has the contract of ``ops.kernels.score_topk.scores_blockmax``:
pad columns score NEG_INF and the per-64-column maxima come with the
scores, so ``blockmax_select`` selects exactly on them.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels import _build
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (
    BLOCK,
    NEG_INF,
)

V = 256  # codebook entries: uint8 codes


def _check(lut: torch.Tensor, codes: torch.Tensor, n_valid: Optional[int]) -> int:
    if lut.dim() != 3 or codes.dim() != 2 or lut.shape[1] != codes.shape[1] or lut.shape[2] != V:
        raise ValueError(f"need lut [nq, M, {V}] and codes [n, M], got "
                         f"{tuple(lut.shape)} and {tuple(codes.shape)}")
    if lut.dtype != torch.float32 or codes.dtype != torch.uint8:
        raise TypeError(f"need a float32 lut and uint8 codes, got {lut.dtype} and {codes.dtype}")
    n = codes.shape[0]
    if n == 0:
        raise ValueError("codes are empty")
    n_valid = n if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid must be in [0, {n}], got {n_valid}")
    return n_valid


def adc_scores_plain(lut: torch.Tensor, codes: torch.Tensor,
                     n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the subquantizers' lookups added in order m =
    0..M-1 (the kernel's order, so the two agree bit for bit), rows from
    ``n_valid`` on and the pad to whole blocks NEG_INF, then the block maxima."""
    n_valid = _check(lut, codes, n_valid)
    nq, M, _ = lut.shape
    n = codes.shape[0]
    nb = -(-n // BLOCK)
    idx = codes[:n_valid].to(torch.int64)
    scores = torch.full((nq, nb * BLOCK), NEG_INF, dtype=torch.float32, device=lut.device)
    if n_valid:
        s = torch.zeros((nq, n_valid), dtype=torch.float32, device=lut.device)
        for m in range(M):
            s = s + lut[:, m, idx[:, m]]
        scores[:, :n_valid] = s
    return scores, scores.view(nq, nb, BLOCK).amax(dim=-1)


def adc_scores(lut: torch.Tensor, codes: torch.Tensor,
               n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC scores of code rows against per-query lookup tables.

    lut: [nq, M, 256] f32 (``retrieval.pq._build_luts``); codes: [n, M]
    uint8. Returns (scores [nq, n_pad] f32, bmax [nq, n_pad / 64] f32),
    n_pad = 64 * ceil(n / 64); rows from ``n_valid`` (default n) on, and the
    pad, score NEG_INF.
    """
    if lut.device.type == "cpu" and codes.device.type == "cpu":
        return adc_scores_plain(lut, codes, n_valid)
    if lut.device.type != "cuda" or codes.device != lut.device:
        raise ValueError(f"lut and codes must be on one CUDA device, got "
                         f"{lut.device} and {codes.device}")
    n_valid = _check(lut, codes, n_valid)
    if not (lut.is_contiguous() and codes.is_contiguous()):
        raise ValueError("lut and codes must be contiguous")
    nq, M, _ = lut.shape
    n = codes.shape[0]
    if M % 16 == 0 and codes.data_ptr() % 16:
        raise ValueError("codes must be 16-byte aligned")  # 16-byte row loads
    n_pad = BLOCK * -(-n // BLOCK)
    dev = lut.device
    scores = torch.empty((nq, n_pad), dtype=torch.float32, device=dev)
    bmax = torch.empty((nq, n_pad // BLOCK), dtype=torch.float32, device=dev)
    if nq == 0:
        return scores, bmax
    lib = _build.load("adc")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adc_scores_forward(lut.data_ptr(), codes.data_ptr(), scores.data_ptr(),
                                     bmax.data_ptr(), nq, n, n_valid, M, n_pad, stream)
    _build.check(err, "adc_scores_forward")
    adc_scores.launches += 1
    return scores, bmax


adc_scores.launches = 0


def launch_plan() -> dict:
    """The kernel's launch plan as ``csrc/adc.cu`` defines it. For the record
    only: the launch needs none of it."""
    keys = ("queries_a_block", "rows_a_block", "subquantizers_a_slice")
    out = (ctypes.c_int * len(keys))()
    _build.check(_build.load("adc").adc_plan(out), "adc_plan")
    return dict(zip(keys, out))
