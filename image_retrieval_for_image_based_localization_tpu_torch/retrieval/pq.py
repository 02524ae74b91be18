"""Product quantization (PQ, OPQ, IVF-PQ), the counterpart of the JAX
package's ``retrieval/pq.py``.

A descriptor is split into ``M`` subvectors, each quantized against a
256-entry codebook, so a row stores as ``M`` uint8 codes (D=2048, M=64:
64 bytes instead of 8 KB). Search is ADC: per query batch one product builds
the lookup tables ``LUT[q, m, v] = <q_m, codebook[m, v]>``, and a row scores
``sum_m LUT[q, m, code[row, m]]``, the exact inner product with the row's
reconstruction. On the card every code chunk is scored by the hand-written
ADC kernel (``ops.kernels.adc``, which replaces the JAX package's Pallas
``adc_scores_mxu``) and its top-k taken by the exact block-max selection;
chunks merge behind the carried list with a stable sort, so ties keep
(score desc, row asc). ``refine=R`` rescores the top-R ADC candidates
against the f32 gallery.

``IVFPQIndex`` stores PQ codes of the residuals (row - centroid) inside the
IVF partitions; a row scores ``<q, centroid> + ADC(residual)``, gathered on
tensors with the IVF tie rule (no TPU kernel scores it in the JAX package
either). OPQ (``opq_iters > 0``) learns an orthogonal rotation first;
queries are rotated for the LUTs only. The ``.npz`` layouts are the JAX
package's, ``rotation`` included.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.adc import adc_scores
from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.score_topk import (
    blockmax_select,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import (
    as_f32,
    order_by_score_then_row,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    INT32_MAX,
    NEG_INF,
    merge_topk,
    sanitize_fill_rows,
    stable_topk,
)
from image_retrieval_for_image_based_localization_tpu_torch.training.netvlad_init import kmeans
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)


def _default_m(d: int) -> int:
    m = max(4, min(256, d // 32))
    while d % m:
        m -= 1
    return m


def _train_codebooks(x: np.ndarray, m: int, kmeans_iters: int, train_sample: int, seed: int,
                     device: DeviceLike = "cuda") -> np.ndarray:
    """k-means per subspace -> codebooks [M, 256, ds] f32; subspace j's init
    rows come from ``torch.Generator().manual_seed(seed + j)``."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if d % m:
        raise ValueError(f"descriptor dim {d} not divisible by M={m}")
    ds = d // m
    train = x
    if n > train_sample:
        sel = np.random.RandomState(seed).choice(n, train_sample, replace=False)
        train = x[np.sort(sel)]
    sub = torch.from_numpy(np.ascontiguousarray(train.reshape(-1, m, ds))).to(dev)
    v = min(256, sub.shape[0])  # degenerate tiny corpora
    books = np.zeros((m, 256, ds), np.float32)
    for j in range(m):
        cent, _ = kmeans(sub[:, j, :], v, iters=kmeans_iters,
                         generator=torch.Generator().manual_seed(seed + j))
        books[j, :v] = cent.cpu().numpy()
        if v < 256:  # pad entries duplicate code 0: never argmin-won
            books[j, v:] = books[j, 0]
    return books


def _decode(codebooks: np.ndarray, codes: np.ndarray) -> np.ndarray:
    """Reconstruct rows from codes: [n, M] uint8 -> [n, D] f32 (host)."""
    M = codebooks.shape[0]
    n = codes.shape[0]
    return codebooks[np.arange(M)[None, :], codes.astype(np.int64)].reshape(n, -1)


def _opq_pca_permutation_init(x: np.ndarray, m: int) -> np.ndarray:
    """OPQ-P initialization (Ge et al., CVPR 2013 §4.1), the JAX package's
    NumPy code as is: the PCA eigenbasis with eigen-directions permuted into
    the ``m`` subspaces so the per-subspace variance products balance
    (eigenvalues descending, each to the least-filled bucket with the
    smallest log-product). Returns an orthogonal [D, D] R."""
    d = x.shape[1]
    xc = x - x.mean(0)
    w, v = np.linalg.eigh((xc.T @ xc) / max(len(x), 1))
    order = np.argsort(w)[::-1]  # eigenvalues descending
    w, v = w[order], v[:, order]
    buckets: list = [[] for _ in range(m)]
    logprod = np.zeros(m)
    for j in range(d):
        # only buckets at the minimum fill level are eligible
        lens = [len(b) for b in buckets]
        lo = min(lens)
        b = min((b for b in range(m) if lens[b] == lo), key=lambda b: logprod[b])
        buckets[b].append(j)
        logprod[b] += np.log(max(w[j], 1e-12))
    perm = [j for bucket in buckets for j in bucket]
    return v[:, perm].astype(np.float32)


def _train_opq_rotation(x: np.ndarray, m: int, opq_iters: int, train_sample: int, seed: int,
                        device: DeviceLike = "cuda") -> np.ndarray:
    """OPQ rotation: from the PCA-permutation init, alternate codebook
    training + encoding in the rotated space with the orthogonal Procrustes
    update ``R = U V^T`` of ``SVD(x^T x_hat)`` (products on ``device``,
    the SVD on the host)."""
    dev = resolve_device(device)
    n, d = x.shape
    if n > train_sample:
        sel = np.random.RandomState(seed).choice(n, train_sample, replace=False)
        x = x[np.sort(sel)]
    R = _opq_pca_permutation_init(x, m)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    for _ in range(opq_iters):
        xr = (xt @ torch.from_numpy(R).to(dev))
        books = _train_codebooks(xr.cpu().numpy(), m, kmeans_iters=8,
                                 train_sample=train_sample, seed=seed, device=dev)
        codes = _encode(torch.from_numpy(books).to(dev), xr).cpu().numpy()
        xhat = torch.from_numpy(_decode(books, codes)).to(dev)
        u, _, vt = np.linalg.svd((xt.T @ xhat).cpu().numpy())
        R = (u @ vt).astype(np.float32)
    return R


def _encode(codebooks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest codebook entry per subspace: [n, D] -> [n, M] uint8, as
    ``argmax(2 <x_m, c> - |c|^2)``; ties go to the lowest code."""
    n, _ = x.shape
    M, V, ds = codebooks.shape
    xc = torch.einsum("nms,mvs->nmv", x.reshape(n, M, ds), codebooks)
    c_sq = torch.sum(codebooks * codebooks, dim=2)
    return torch.argmax(2.0 * xc - c_sq[None], dim=2).to(torch.uint8)


def _encode_all(books: np.ndarray, x: np.ndarray, dev: torch.device) -> np.ndarray:
    bt = torch.from_numpy(books).to(dev)
    codes = np.empty((x.shape[0], books.shape[0]), np.uint8)
    step = 65536
    for i in range(0, x.shape[0], step):
        codes[i : i + step] = _encode(bt, torch.from_numpy(
            np.ascontiguousarray(x[i : i + step], np.float32)).to(dev)).cpu().numpy()
    return codes


def _build_luts(codebooks: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Inner-product lookup tables: [nq, M, 256] f32, one product."""
    nq = q.shape[0]
    M, V, ds = codebooks.shape
    return torch.einsum("qms,mvs->qmv", q.reshape(nq, M, ds), codebooks).contiguous()


def adc_topk_core(lut: torch.Tensor, codes: torch.Tensor, k: int, chunk: int,
                  n_valid: Optional[int] = None, index_offset: int = 0,
                  backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming ADC top-k over a code matrix: ``(scores [nq, k] f32, rows
    [nq, k] int32)``, best first, ties lower row first.

    Each code chunk is scored by ``ops.kernels.adc.adc_scores`` (the kernel
    on the card, its plain version on the CPU), rows >= ``n_valid`` scoring
    NEG_INF; its top-k comes from ``blockmax_select`` and merges behind the
    carried list with a stable sort. Row ids start at ``index_offset``.

    ``backend`` is accepted for the JAX package's signature: its ``'mxu'``
    backend is a bf16x2 approximation of the gather that runs only on the
    TPU; here every value computes the exact f32 gather, so on the card
    every backend launches the ADC kernel.
    """
    if backend not in ("auto", "gather", "mxu"):
        raise ValueError(f"backend must be auto/gather/mxu, got {backend!r}")
    N = codes.shape[0]
    nq = lut.shape[0]
    n_valid = N if n_valid is None else int(n_valid)
    k = min(k, N)
    chunk = min(max(chunk, k), N)
    dev = lut.device
    best_s = torch.full((nq, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((nq, k), INT32_MAX, dtype=torch.int64, device=dev)
    for start in range(0, N, chunk):
        block = codes[start : start + chunk]
        nv = max(0, min(block.shape[0], n_valid - start))
        scores, bmax = adc_scores(lut, block, n_valid=nv)
        cs, cpos = blockmax_select(scores, bmax, k)
        best_s, best_i = merge_topk(
            torch.cat([best_s, cs], dim=1),
            torch.cat([best_i, cpos.to(torch.int64) + (index_offset + start)], dim=1), k)
    return best_s.contiguous(), best_i.to(torch.int32).contiguous()


def _exact_rescore(gallery: torch.Tensor, q: torch.Tensor, cand: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact scores of the candidate rows, top-k with the tie contract.
    Candidates are re-sorted by row first; rows >= len(gallery) (sentinels
    of an under-filled probe) score NEG_INF."""
    n = gallery.shape[0]
    cand = torch.sort(cand.to(torch.int64), dim=1).values
    sub = gallery[torch.clamp(cand, 0, n - 1)]             # [nq, R, D]
    return rescore_rows(sub, q, cand, n, k)


def rescore_rows(sub: torch.Tensor, q: torch.Tensor, cand: torch.Tensor, n: int,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-score pre-gathered rows ``sub [nq, R, D]`` (``cand`` ascending
    per query) and take top-k; rows >= n score NEG_INF."""
    s = torch.einsum("qd,qrd->qr", q.to(sub.dtype).float(), sub.float())
    s = torch.where(cand < n, s, torch.full_like(s, NEG_INF))
    top, rows = merge_topk(s, cand, k)
    return top, rows.to(torch.int32)


class PQIndex:
    """PQ-compressed gallery: codes [N, M] uint8 + codebooks [M, 256, ds],
    with an optional OPQ ``rotation`` [D, D] applied to queries."""

    def __init__(self, codebooks, codes, n: int, rotation=None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.codebooks = np.asarray(codebooks, np.float32)
        self.codes = np.asarray(codes, np.uint8)
        self.n = int(n)
        self.rotation = None if rotation is None else np.asarray(rotation, np.float32)
        self._dev = None

    @classmethod
    def build(cls, gallery, m: Optional[int] = None, kmeans_iters: int = 25,
              train_sample: int = 262_144, seed: int = 0, opq_iters: int = 0,
              device: DeviceLike = "cuda") -> "PQIndex":
        """Train codebooks on the gallery and encode it; ``m`` defaults to
        D/32 (a divisor of D in [4, 256]); ``opq_iters > 0`` learns an OPQ
        rotation first and trains/encodes in the rotated space."""
        dev = resolve_device(device)
        g = np.asarray(gallery, np.float32)
        m = m or _default_m(g.shape[1])
        rotation = None
        if opq_iters:
            rotation = _train_opq_rotation(g, m, opq_iters, train_sample, seed, device=dev)
            g = (as_f32(g, dev) @ torch.from_numpy(rotation).to(dev)).cpu().numpy()
        books = _train_codebooks(g, m, kmeans_iters, train_sample, seed, device=dev)
        return cls(books, _encode_all(books, g, dev), g.shape[0], rotation=rotation, device=dev)

    def _device(self):
        if self._dev is None:
            rot = None if self.rotation is None else torch.from_numpy(self.rotation)
            self._dev = tuple(None if t is None else t.to(self.device) for t in (
                torch.from_numpy(self.codebooks), torch.from_numpy(self.codes), rot))
        return self._dev

    def search(self, queries, k: int = 10, chunk: int = 65536, refine: int = 0,
               gallery=None, backend: str = "auto") -> Tuple[np.ndarray, np.ndarray]:
        """ADC top-k: ``(scores [nq, k], gallery rows [nq, k])``.

        ``refine=R`` (with the f32 ``gallery``, numpy or a tensor) takes the
        top-R ADC candidates and exact rescoring decides the top k; scores
        are then true inner products. ``backend`` is accepted for the JAX
        package's signature (see :func:`adc_topk_core`)."""
        books, codes, rot = self._device()
        q = as_f32(queries, self.device).reshape(-1, books.shape[0] * books.shape[2])
        q_adc = q if rot is None else q @ rot
        k_eff = min(k, self.n)
        lut = _build_luts(books, q_adc)
        if refine:
            if gallery is None:
                raise ValueError("refine requires the f32 gallery")
            R = min(max(refine, k_eff), self.n)
            _, cand = adc_topk_core(lut, codes, k=R, chunk=min(chunk, self.n), backend=backend)
            s, i = _exact_rescore(as_f32(gallery, self.device), q, cand, k_eff)
        else:
            s, i = adc_topk_core(lut, codes, k=k_eff, chunk=min(chunk, self.n), backend=backend)
        return s.cpu().numpy(), i.cpu().numpy()

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        extra = {} if self.rotation is None else {"rotation": self.rotation}
        np.savez_compressed(
            path, codebooks=self.codebooks, codes=self.codes,
            meta=np.frombuffer(json.dumps({"n": self.n, "version": 1}).encode(), np.uint8),
            **extra)

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda") -> "PQIndex":
        dev = resolve_device(device)
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            rot = z["rotation"] if "rotation" in z.files else None
            return cls(z["codebooks"], z["codes"], meta["n"], rotation=rot, device=dev)


def load_pq_artifact(path: str, device: DeviceLike = "cuda"):
    """Load a ``.pq.npz`` / ``.ivfpq.npz`` artifact saved by either package,
    flat PQ or IVF-PQ by the arrays it carries (IVF-PQ has ``centroids``)."""
    dev = resolve_device(device)
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as z:
        is_ivfpq = "centroids" in z.files
    return (IVFPQIndex if is_ivfpq else PQIndex).load(path, device=dev)


# ---------------------------------------------------------------------------
# IVF-PQ: residual codes inside IVF partitions
# ---------------------------------------------------------------------------


def _ivfpq_search_chunk(cent, codes, lengths, row_ids, codebooks, q, q_lut, k: int,
                        nprobe: int):
    """IVF probe scored by residual ADC: score = coarse score + sum of the
    residual codes' LUT entries, with the IVF tie rule. ``q_lut`` is the
    query in the codebook space (q, or q @ rotation for OPQ)."""
    cs = q @ cent.T
    probe_s, probe = stable_topk(cs, nprobe)               # [nq, P]
    sub = codes[probe]                                     # [nq, P, L, M] uint8
    lut = _build_luts(codebooks, q_lut)                    # [nq, M, 256]
    nq, P, L, M = sub.shape
    idx = sub.permute(0, 3, 1, 2).reshape(nq, M, P * L).to(torch.int64)
    g = torch.gather(lut, 2, idx)                          # [nq, M, P*L]
    scores = g.sum(dim=1).reshape(nq, P, L) + probe_s[:, :, None]
    valid = torch.arange(L, device=q.device)[None, None, :] < lengths[probe][:, :, None]
    rows = row_ids[probe]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    rows = torch.where(valid, rows, torch.full_like(rows, INT32_MAX))
    s_top, pos = stable_topk(scores.reshape(nq, -1), k)
    return order_by_score_then_row(s_top, torch.gather(rows.reshape(nq, -1), 1, pos))


class IVFPQIndex:
    """IVF coarse quantizer + PQ residual codes [C, L, M] per partition, with
    an optional OPQ ``rotation`` over the residuals (queries rotated for the
    LUTs only; coarse scoring stays in the original space)."""

    def __init__(self, centroids, codes, lengths, row_ids, codebooks, n: int, rotation=None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.centroids = np.asarray(centroids, np.float32)
        self.codes = np.asarray(codes, np.uint8)
        self.lengths = np.asarray(lengths, np.int32)
        self.row_ids = np.asarray(row_ids, np.int32)
        self.codebooks = np.asarray(codebooks, np.float32)
        self.n = int(n)
        self.rotation = None if rotation is None else np.asarray(rotation, np.float32)
        self._dev = None

    @classmethod
    def from_ivf(cls, ivf, m: Optional[int] = None, kmeans_iters: int = 25,
                 train_sample: int = 262_144, seed: int = 0, opq_iters: int = 0,
                 device: DeviceLike = "cuda") -> "IVFPQIndex":
        """Encode an f32 ``IVFIndex``'s partitions as PQ residual codes."""
        if getattr(ivf, "dtype", "f32") != "f32":
            raise ValueError(
                "IVFPQIndex.from_ivf needs f32 partitions (build the IVF with dtype='f32', "
                f"got {ivf.dtype!r}): residuals of already-quantized rows would "
                "double-compress")
        dev = resolve_device(device)
        parts = np.asarray(ivf.partitions, np.float32)      # [C, L, D]
        C, L, D = parts.shape
        m = m or _default_m(D)
        valid = np.arange(L)[None, :] < ivf.lengths[:, None]
        resid = parts - ivf.centroids[:, None, :]
        train = resid[valid]
        rotation = None
        if opq_iters:
            rotation = _train_opq_rotation(train, m, opq_iters, train_sample, seed, device=dev)
            rt = torch.from_numpy(rotation).to(dev)
            train = (as_f32(train, dev) @ rt).cpu().numpy()
            resid = (as_f32(resid.reshape(C * L, D), dev) @ rt).cpu().numpy()
        books = _train_codebooks(train, m, kmeans_iters, train_sample, seed, device=dev)
        codes = _encode_all(books, resid.reshape(C * L, D), dev)
        return cls(ivf.centroids, codes.reshape(C, L, m), ivf.lengths, ivf.row_ids, books,
                   ivf.n, rotation=rotation, device=dev)

    def _device(self):
        if self._dev is None:
            self._dev = tuple(torch.from_numpy(a).to(self.device) for a in (
                self.centroids, self.codes, self.lengths, self.row_ids, self.codebooks))
        return self._dev

    def search(self, queries, k: int = 10, nprobe: int = 8, chunk: int = 32, refine: int = 0,
               gallery=None) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate top-k over probed partitions, residual-ADC scored;
        fill slots row -1."""
        cent, codes, lengths, row_ids, books = self._device()
        C, L, M = codes.shape
        P = min(nprobe, C)
        k_stage = min(max(refine, k) if refine else k, P * L, self.n)
        q = as_f32(queries, self.device).reshape(-1, cent.shape[1])
        q_lut = q if self.rotation is None else q @ torch.from_numpy(self.rotation).to(q.device)
        outs, outi = [], []
        for i in range(0, q.shape[0], chunk):
            s, r = _ivfpq_search_chunk(cent, codes, lengths, row_ids, books, q[i : i + chunk],
                                       q_lut[i : i + chunk], k=k_stage, nprobe=P)
            outs.append(s)
            outi.append(r)
        s, r = torch.cat(outs), torch.cat(outi)
        if refine:
            if gallery is None:
                raise ValueError("refine requires the f32 gallery")
            # sentinel rows of an under-filled probe score NEG_INF in the rescore
            s, r = _exact_rescore(as_f32(gallery, self.device), q, r,
                                  k=min(k, self.n, k_stage))
        s = s.cpu().numpy()
        return s, sanitize_fill_rows(s, r.cpu().numpy())

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        extra = {} if self.rotation is None else {"rotation": self.rotation}
        np.savez_compressed(
            path, centroids=self.centroids, codes=self.codes, lengths=self.lengths,
            row_ids=self.row_ids, codebooks=self.codebooks,
            meta=np.frombuffer(json.dumps({"n": self.n, "version": 1}).encode(), np.uint8),
            **extra)

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda") -> "IVFPQIndex":
        dev = resolve_device(device)
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            rot = z["rotation"] if "rotation" in z.files else None
            return cls(z["centroids"], z["codes"], z["lengths"], z["row_ids"], z["codebooks"],
                       meta["n"], rotation=rot, device=dev)
