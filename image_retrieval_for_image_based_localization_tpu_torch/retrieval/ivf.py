"""IVF (inverted-file) approximate search, the counterpart of the JAX
package's ``retrieval/ivf.py``.

k-means partitions the gallery once at build; each query scores the ``C``
centroids, probes its top-``nprobe`` partitions and scores only their rows
exactly. Partitions are a padded dense tensor ``[C, L, D]`` (f32, bf16 or
int8), masked by length; pad slots score NEG_INF and carry the int32-max
sentinel row, which the host turns into row -1. With ``nprobe == C`` the
result is exact search.

Ties follow the JAX search step for step: the coarse top-``nprobe`` is a
stable sort over centroid index, the flat selection over the ``[P * L]``
probed slots keeps the lower slot position, and only the k winners are then
ordered by (score desc, row asc). So among rows tied at the k-th place,
probe order decides which enter, as in the JAX package. Save and load use
the same ``.npz`` layout, so each package loads the other's index.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    INT32_MAX,
    NEG_INF,
    sanitize_fill_rows,
    stable_topk,
)
from image_retrieval_for_image_based_localization_tpu_torch.training.netvlad_init import kmeans
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)

_DTYPES = ("f32", "bf16", "int8")


def as_f32(x, dev: torch.device) -> torch.Tensor:
    """A numpy array or a tensor as f32 on ``dev``."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    return t.float().to(dev)


def order_by_score_then_row(s: torch.Tensor, r: torch.Tensor):
    """Sort each row by (score desc, row asc): ``lexsort((r, -s))``."""
    o = torch.sort(r, dim=1, stable=True).indices
    s, r = torch.gather(s, 1, o), torch.gather(r, 1, o)
    o = torch.sort(s, dim=1, descending=True, stable=True).indices
    return torch.gather(s, 1, o), torch.gather(r, 1, o)


class IVFIndex:
    """Coarse-quantized gallery with padded dense partitions.

    Host arrays as in the JAX package: ``centroids`` [C, D] f32,
    ``partitions`` [C, L, D] (f32 numpy, int8 numpy, or for bf16 a
    ``torch.bfloat16`` tensor), ``lengths`` [C], ``row_ids`` [C, L] (pad 0).
    The device copies are made once on ``device``.
    """

    def __init__(self, centroids, partitions, lengths, row_ids, n: int, dtype: str = "f32",
                 device: DeviceLike = "cuda"):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be f32/bf16/int8, got {dtype!r}")
        self.device = resolve_device(device)
        self.centroids = np.asarray(centroids, np.float32)
        self.dtype = dtype
        if dtype == "f32":
            self.partitions = np.asarray(partitions, np.float32)
        elif dtype == "bf16":
            p = partitions
            self.partitions = (p.to(torch.bfloat16) if isinstance(p, torch.Tensor)
                               else torch.from_numpy(np.asarray(p, np.float32)).to(torch.bfloat16))
        else:
            self.partitions = np.asarray(partitions, np.int8)
        self.lengths = np.asarray(lengths, np.int32)
        self.row_ids = np.asarray(row_ids, np.int32)
        self.n = int(n)
        self._dev = None

    @property
    def pad_ratio(self) -> float:
        C, L, _ = self.partitions.shape
        return C * L / max(self.n, 1)

    @classmethod
    def build(cls, gallery, n_clusters: Optional[int] = None, kmeans_iters: int = 25,
              train_sample: int = 262_144, seed: int = 0, balance: Optional[float] = 2.0,
              dtype: str = "f32", device: DeviceLike = "cuda") -> "IVFIndex":
        """Partition the gallery (the JAX package's ``IVFIndex.build``).

        ``n_clusters`` defaults to ~sqrt(N); k-means (on ``device``, init
        rows from ``torch.Generator().manual_seed(seed)``) trains on at most
        ``train_sample`` rows; ``balance`` caps every partition at
        ``ceil(N / C * balance)`` rows by the JAX package's greedy host
        assignment over each row's 8 nearest centroids (``None``: nearest
        centroid only); ``dtype`` stores partitions as f32, bf16 or int8
        (symmetric /127).
        """
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be f32/bf16/int8, got {dtype!r}")
        dev = resolve_device(device)
        g = np.asarray(gallery, np.float32)
        n, d = g.shape
        C = n_clusters or max(1, int(round(np.sqrt(n))))
        train = g
        if n > train_sample:
            sel = np.random.RandomState(seed).choice(n, train_sample, replace=False)
            train = g[np.sort(sel)]
        cent_t, _ = kmeans(torch.from_numpy(train).to(dev), C, iters=kmeans_iters,
                           generator=torch.Generator().manual_seed(seed))
        cent = cent_t.cpu().numpy()
        # each row's nearest centroids, nearest first (stable over centroid id)
        n_pref = min(8, C)
        prefs = np.empty((n, n_pref), np.int32)
        c_sq = torch.sum(cent_t * cent_t, dim=1)[None, :]
        step = 65536
        for i in range(0, n, step):
            x = torch.from_numpy(g[i : i + step]).to(dev)
            _, top = stable_topk(2.0 * (x @ cent_t.T) - c_sq, n_pref)
            prefs[i : i + step] = top.cpu().numpy()

        if balance is None:
            assign = prefs[:, 0].copy()
        else:
            # the JAX package's capacity-constrained greedy assignment, as is
            cap = int(np.ceil(n / C * float(balance)))
            fill = np.zeros(C, np.int64)
            assign = np.full(n, -1, np.int32)
            spill = []
            order = np.random.RandomState(seed).permutation(n)
            for r in order:
                for c in prefs[r]:
                    if fill[c] < cap:
                        assign[r] = c
                        fill[c] += 1
                        break
                else:
                    spill.append(r)
            if spill:
                sp = np.asarray(spill)
                d2 = -2.0 * g[sp] @ cent.T + np.sum(cent * cent, axis=1)[None]
                for r, dr in zip(sp, np.argsort(d2, axis=1)):
                    for c in dr:
                        if fill[c] < cap:
                            assign[r] = c
                            fill[c] += 1
                            break

        counts = np.bincount(assign, minlength=C)
        L = int(counts.max())
        parts = np.zeros((C, L, d), np.float32)
        ids = np.zeros((C, L), np.int32)
        cursor = np.zeros(C, np.int64)
        for r in np.argsort(assign, kind="stable"):
            c = assign[r]
            j = cursor[c]
            parts[c, j] = g[r]
            ids[c, j] = r
            cursor[c] = j + 1
        if dtype == "int8":
            parts = np.clip(np.round(parts * 127.0), -127, 127).astype(np.int8)
        return cls(cent, parts, counts.astype(np.int32), ids, n, dtype=dtype, device=dev)

    # -- search --------------------------------------------------------------

    def _device(self):
        if self._dev is None:
            dev = self.device
            parts = (self.partitions if isinstance(self.partitions, torch.Tensor)
                     else torch.from_numpy(self.partitions))
            self._dev = (torch.from_numpy(self.centroids).to(dev), parts.to(dev).contiguous(),
                         torch.from_numpy(self.lengths).to(dev),
                         torch.from_numpy(self.row_ids).to(dev))
        return self._dev

    def search(self, queries, k: int = 10, nprobe: int = 8, chunk: int = 32,
               gather_budget_bytes: int = 1 << 30) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate top-k: ``(scores [Nq, k], gallery rows [Nq, k])``,
        fill slots row -1. ``chunk`` queries go through one probe; it shrinks
        to keep the gathered ``[chunk, nprobe, L, D]`` block under
        ``gather_budget_bytes``."""
        cent, parts, lengths, row_ids = self._device()
        C, L, D = parts.shape
        P = min(nprobe, C)
        k_eff = min(k, P * L)
        itemsize = parts.element_size()
        chunk = max(1, min(chunk, gather_budget_bytes // (P * L * D * itemsize)))
        q = as_f32(queries, self.device).reshape(-1, D)
        outs, outi = [], []
        for i in range(0, q.shape[0], chunk):
            s, r = _ivf_search_chunk(cent, parts, lengths, row_ids, q[i : i + chunk],
                                     k=k_eff, nprobe=P)
            outs.append(s.cpu().numpy())
            outi.append(r.cpu().numpy())
        s = np.concatenate(outs)
        return s, sanitize_fill_rows(s, np.concatenate(outi))

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` layout (bf16 as a uint16 bit-view)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        parts = self.partitions
        if self.dtype == "bf16":
            parts = parts.view(torch.uint16).numpy()
        np.savez_compressed(
            path, centroids=self.centroids, partitions=parts,
            lengths=self.lengths, row_ids=self.row_ids,
            meta=np.frombuffer(json.dumps({"n": self.n, "dtype": self.dtype,
                                           "version": 1}).encode(), np.uint8),
        )

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda") -> "IVFIndex":
        """Load an IVF index saved by either package."""
        dev = resolve_device(device)
        if not path.endswith(".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            dtype = meta.get("dtype", "f32")
            parts = z["partitions"]
            if dtype == "bf16":  # saved as a uint16 bit-view
                parts = torch.from_numpy(np.ascontiguousarray(parts, np.uint16)).view(
                    torch.bfloat16)
            return cls(z["centroids"], parts, z["lengths"], z["row_ids"], meta["n"],
                       dtype=dtype, device=dev)


def _ivf_search_chunk(cent, parts, lengths, row_ids, q, k: int, nprobe: int):
    """One query chunk: probe, exact scores of the probed rows, top-k.

    The gather runs at the stored dtype; int8 rows are widened to f32 and the
    scores scaled by 1/127 after the product, and for bf16 rows the queries
    are rounded to bf16 and the exact bf16 products summed in f32.
    """
    cs = q @ cent.T                                       # [nq, C]
    _, probe = stable_topk(cs, nprobe)                    # [nq, P]
    sub = parts[probe]                                    # [nq, P, L, D]
    if parts.dtype == torch.int8:
        scores = torch.einsum("qd,qpld->qpl", q, sub.float()) * (1.0 / 127.0)
    else:
        qd = q.to(parts.dtype).float()
        scores = torch.einsum("qd,qpld->qpl", qd, sub.float())
    L = parts.shape[1]
    valid = torch.arange(L, device=q.device)[None, None, :] < lengths[probe][:, :, None]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    rows = torch.where(valid, row_ids[probe], torch.full_like(row_ids[probe], INT32_MAX))
    nq = q.shape[0]
    s_top, pos = stable_topk(scores.reshape(nq, -1), k)   # lower slot position on ties
    r_top = torch.gather(rows.reshape(nq, -1), 1, pos)
    return order_by_score_then_row(s_top, r_top)
