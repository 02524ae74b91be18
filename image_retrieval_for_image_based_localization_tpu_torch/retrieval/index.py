"""The descriptor Index: whitening + gallery + exact search + persistence.

The JAX package's ``retrieval/index.py``: the gallery matrix, whitening
``(m, P)`` and the image-id list save and load as one compressed ``.npz`` in
the same layout, so each package loads the other's index. A large gallery
can go to an uncompressed ``.gallery.npy`` sidecar instead, which loads
memory-mapped. A bf16 gallery is written as a ``uint16`` bit-view with
``meta["gallery_dtype"] = "bfloat16"`` and held as that bit-view on the host:
nothing widens it to f32.

Search routing in :meth:`Index.query` is a fixed rule on shape and dtype:
exact top-k with ``k <= 128`` over an f32 or bf16 gallery and no query
expansion goes to the hand-written fused top-k kernel
(``ops.kernels.fused_topk``); everything else goes to the chunked exact
search (``retrieval.knn.knn_search``), which on the card scores f32/bf16
chunks with the score/block-max kernel (``ops.kernels.score_topk``) and
int8 storage with a dense product and a stable sort.

The re-ranking family is the JAX package's: αQE on the queries
(``query(qe_nqe=...)``, ``ranks(qe_nqe=...)``), DBA on the gallery at build
(``IndexConfig.dba_nqe``), both ``retrieval.query_expansion``, and
kNN-graph diffusion (:meth:`Index.diffusion_ranks`,
``retrieval.diffusion``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.ops.kernels.fused_topk import (
    LANES,
    fused_topk_search,
)
from image_retrieval_for_image_based_localization_tpu_torch.ops.whitening import (
    pca_whiten_learn,
    whiten_apply,
    whiten_learn,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.diffusion import (
    DiffusionGraph,
    build_graph,
    diffusion_scores,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    full_ranks,
    knn_search,
    score_matrix,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.query_expansion import (
    expand_queries,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import IndexConfig
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import (
    DeviceLike,
    resolve_device,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import span

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
DBA_BLOCK = 8192  # gallery rows expanded at a time by DBA (bounds its gather)


@dataclasses.dataclass
class Index:
    """Exact-search descriptor index.

    ``gallery`` holds the whitened, L2-normalized rows [N, D'] as one of: a
    host f32 array; a host ``uint16`` array, the bit-view of a bf16 gallery
    (what :meth:`load` gives for a bf16 artifact, memory-mapped from a
    sidecar); or a torch tensor, such as a bf16 gallery already on the
    card. The device copy is made once in the ``storage`` dtype ('float32',
    'bfloat16', or 'int8' as symmetric /127 quantization) on ``device``.
    """

    gallery: Union[np.ndarray, torch.Tensor]
    m: Optional[np.ndarray] = None      # whitening mean [D]
    P: Optional[np.ndarray] = None      # whitening projection [D', D]
    dims: Optional[int] = None
    ids: Optional[np.ndarray] = None
    storage: str = "float32"
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))
    _device_gallery: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)
    _device_mP: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _diffusion_cache: Dict[Tuple[int, float], DiffusionGraph] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def device_gallery(self) -> torch.Tensor:
        """Device-resident gallery in the ``storage`` dtype, uploaded once.
        A bf16 bit-view is viewed as bf16 (never widened on the host)."""
        if self._device_gallery is None:
            if self.storage not in _STORAGE:
                raise ValueError(f"unknown storage {self.storage!r}")
            g = self.gallery
            if isinstance(g, np.ndarray) and g.dtype == np.uint16:
                with warnings.catch_warnings():  # a read-only memory map
                    warnings.simplefilter("ignore", UserWarning)
                    g = torch.from_numpy(np.ascontiguousarray(g)).view(torch.bfloat16)
            elif not isinstance(g, torch.Tensor):
                g = torch.from_numpy(np.ascontiguousarray(g, dtype=np.float32))
            g = g.to(self.device)
            if self.storage == "int8":
                g = torch.clamp(torch.round(g.float() * 127.0), -127, 127)
            self._device_gallery = g.to(_STORAGE[self.storage]).contiguous()
        return self._device_gallery

    @classmethod
    def build(
        cls,
        descriptors: np.ndarray,
        cfg: IndexConfig = IndexConfig(),
        ids: Optional[Sequence] = None,
        pairs: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        whitening_mP: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        device: DeviceLike = "cuda",
    ) -> "Index":
        """Learn whitening on the gallery (host, float64) and apply it on
        ``device``. ``pairs=(qidxs, pidxs)`` selects supervised Lw whitening;
        ``whitening_mP=(m, P)`` applies pre-learned whitening instead."""
        dev = resolve_device(device)
        descriptors = np.asarray(descriptors, dtype=np.float32)
        m = P = None
        if whitening_mP is not None:
            m = np.asarray(whitening_mP[0], np.float32)
            P = np.asarray(whitening_mP[1], np.float32)
        elif cfg.whitening == "pca":
            learn_set = descriptors
            if cfg.whiten_sample and descriptors.shape[0] > cfg.whiten_sample:
                sel = np.random.RandomState(0).choice(
                    descriptors.shape[0], cfg.whiten_sample, replace=False)
                learn_set = descriptors[np.sort(sel)]
            m, P = pca_whiten_learn(learn_set, shrinkage=cfg.shrinkage,
                                    strict=cfg.strict_whitening)
        elif cfg.whitening == "lw":
            if pairs is None:
                raise ValueError("Lw whitening requires pairs=(qidxs, pidxs)")
            m, P = whiten_learn(descriptors, pairs[0], pairs[1])
        elif cfg.whitening is not None:
            raise ValueError(f"unknown whitening {cfg.whitening!r}")

        gallery = descriptors
        if P is not None:
            m = np.asarray(m, np.float32)
            P = np.asarray(P, np.float32)
            mt = torch.from_numpy(m).to(dev)
            Pt = torch.from_numpy(P).to(dev)
            step = 65536  # bound the device copy of a large gallery
            blocks = [
                whiten_apply(torch.from_numpy(descriptors[i : i + step]).to(dev),
                             mt, Pt, cfg.whiten_dims).cpu().numpy()
                for i in range(0, descriptors.shape[0], step)
            ]
            gallery = np.concatenate(blocks, axis=0)
        if cfg.dba_nqe:
            # database-side augmentation: gallery -> gallery αQE in the search
            # space; a row's first neighbour is itself (s = 1), so it carries
            # weight 1 + 1 with the explicit query term, the usual DBA
            gdev = torch.from_numpy(np.ascontiguousarray(gallery, np.float32)).to(dev)
            nqe = min(int(cfg.dba_nqe), gallery.shape[0])
            gallery = np.concatenate([
                expand_queries(gdev, gdev[i : i + DBA_BLOCK], nqe=nqe,
                               alpha=cfg.dba_alpha).cpu().numpy()
                for i in range(0, gallery.shape[0], DBA_BLOCK)], axis=0)
        return cls(
            gallery=gallery, m=m, P=P, dims=cfg.whiten_dims,
            ids=None if ids is None else np.asarray(ids),
            storage=cfg.storage, device=dev,
        )

    def transform_queries(self, qdescriptors) -> torch.Tensor:
        """The index's whitening applied to query descriptors (a host array,
        or a tensor, which is not copied through the host), on the device."""
        with span("Index.h2d"):
            if isinstance(qdescriptors, torch.Tensor):
                q = qdescriptors.to(self.device, torch.float32)
            else:
                q = torch.as_tensor(np.asarray(qdescriptors, dtype=np.float32)).to(self.device)
        if q.dim() == 1:
            q = q[None, :]
        if self.P is None:
            return q
        with span("Index.whiten"):
            if self._device_mP is None:
                self._device_mP = (torch.from_numpy(self.m).to(self.device),
                                   torch.from_numpy(self.P).to(self.device))
            return whiten_apply(q, *self._device_mP, self.dims)

    def _search_queries(self, qdescriptors, qe_nqe: int = 0, qe_alpha: float = 3.0,
                        pre_transformed: bool = False) -> torch.Tensor:
        """Whitened (unless ``pre_transformed``) and, with ``qe_nqe``,
        αQE-expanded queries on the device."""
        if pre_transformed:
            with span("Index.h2d"):
                q = torch.as_tensor(qdescriptors).to(self.device, torch.float32)
        else:
            q = self.transform_queries(qdescriptors)
        if qe_nqe:
            with span("Index.whiten"):
                q = expand_queries(self.device_gallery(), q,
                                   nqe=min(int(qe_nqe), self.gallery.shape[0]), alpha=qe_alpha)
        return q

    def query(self, qdescriptors, k: int = 10, qe_nqe: int = 0, qe_alpha: float = 3.0,
              method: str = "exact",
              recall_target: float = 0.95) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k search. Returns (scores [Nq,k] f32, indices [Nq,k] int32).

        ``qe_nqe > 0`` expands the queries by αQE first (one more search).

        ``method="approx"`` stands for the JAX package's ``lax.approx_max_k``,
        the TPU's hardware selection at ``recall_target``. The port runs the
        exact search for it, which meets any recall target; nothing
        approximates the selection.

        Its stages are spans (``utils.metrics.span``): ``Index.query``
        around the call; inside it ``Index.h2d`` (the queries to the
        device), ``Index.whiten`` (whitening, and αQE where asked),
        ``Index.topk`` (the routed search's host path and launch) and
        ``Index.d2h`` (the results to the host).
        """
        if method not in ("exact", "approx"):
            raise ValueError(f"unknown query method {method!r} (exact|approx)")
        if method == "approx" and not 0.0 < recall_target <= 1.0:
            raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
        with span("Index.query"):
            scores, idx = self.query_device(qdescriptors, k, qe_nqe, qe_alpha)
            with span("Index.d2h"):
                return scores.cpu().numpy(), idx.cpu().numpy()

    def query_device(self, qdescriptors, k: int = 10, qe_nqe: int = 0,
                     qe_alpha: float = 3.0, pre_transformed: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`query`'s exact search, its result left on the device:
        ``(scores [Nq, k] f32, indices [Nq, k] int32)`` tensors.
        ``qdescriptors`` may be a tensor already on the device (serving's
        one-hop query hands the extractor's output over this way), and
        already whitened with ``pre_transformed``.

        Routing: whitening, then the fused top-k kernel for ``k <= 128``
        over f32 or bf16 storage without αQE, else ``knn_search``."""
        q = self._search_queries(qdescriptors, qe_nqe, qe_alpha, pre_transformed)
        g = self.device_gallery()
        with span("Index.topk"):
            if not qe_nqe and k <= LANES and self.storage in ("float32", "bfloat16"):
                return fused_topk_search(g, q, k)
            return knn_search(g, q, k)

    def ranks(self, qdescriptors, qe_nqe: int = 0, qe_alpha: float = 3.0) -> np.ndarray:
        """Full ranking [N, Nq] for mAP evaluation (αQE with ``qe_nqe``)."""
        return full_ranks(self.device_gallery(),
                          self._search_queries(qdescriptors, qe_nqe, qe_alpha))

    def diffusion_ranks(self, qdescriptors, k_graph: int = 50, k_seed: int = 10,
                        gamma: float = 3.0, alpha: float = 0.9, iters: int = 30,
                        qe_nqe: int = 0, qe_alpha: float = 3.0) -> np.ndarray:
        """Full ranking [N, Nq] by kNN-graph diffusion (``retrieval.diffusion``;
        αQE with ``qe_nqe`` applies to the seeds' search).

        The graph does not depend on the queries and is built once per
        ``(k_graph, gamma)``. Rows the diffusion reaches (``f > 0``) rank
        above every other row, by ``3 + f``; the rest keep their cosine
        order (int8 storage dequantized) below them."""
        q = self._search_queries(qdescriptors, qe_nqe, qe_alpha)
        g = self.device_gallery()
        key = (int(k_graph), float(gamma))
        graph = self._diffusion_cache.get(key)
        if graph is None:
            graph = self._diffusion_cache[key] = build_graph(g, k=k_graph, gamma=gamma)
        f = diffusion_scores(g, q, graph=graph, k_graph=k_graph, k_seed=k_seed, gamma=gamma,
                             alpha=alpha, iters=iters)
        cos = score_matrix(g, q).T.cpu().numpy()  # [N, Nq]
        final = np.where(f > 0, 3.0 + f, cos)   # any reached row above cos <= 1 < 3
        return np.argsort(-final, axis=0, kind="stable")

    # -- persistence ---------------------------------------------------------

    def save(self, path: str, external_gallery: bool = False) -> None:
        """Persist in the JAX package's layout: one compressed npz, or with
        ``external_gallery=True`` the small arrays in the npz and the gallery
        as an uncompressed ``<path>.gallery.npy`` sidecar (written to a
        ``.tmp`` file, then renamed), which :meth:`load` maps. A bf16
        gallery is written as its ``uint16`` bit-view with
        ``meta["gallery_dtype"] = "bfloat16"``."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        meta = {"dims": self.dims, "version": 1, "storage": self.storage}
        arrays = dict(
            m=np.zeros(0) if self.m is None else self.m,
            P=np.zeros((0, 0)) if self.P is None else self.P,
            ids=np.zeros(0) if self.ids is None else self.ids,
        )
        gallery = self.gallery
        if isinstance(gallery, torch.Tensor):
            gallery = gallery.detach().cpu().contiguous()
            gallery = (gallery.view(torch.int16).numpy().view(np.uint16)
                       if gallery.dtype == torch.bfloat16 else gallery.numpy())
        gallery = np.asarray(gallery)
        if gallery.dtype == np.uint16:
            meta["gallery_dtype"] = "bfloat16"
        if external_gallery:
            gpath = path.removesuffix(".npz") + ".gallery.npy"
            meta["external_gallery"] = os.path.basename(gpath)
            tmp = gpath + ".tmp"
            with open(tmp, "wb") as f:  # a file object: np.save adds no suffix
                np.save(f, gallery)
            os.replace(tmp, gpath)
        else:
            arrays["gallery"] = gallery
        np.savez_compressed(
            path,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **arrays,
        )

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda") -> "Index":
        """Load an index saved by either package. A sidecar gallery stays
        memory-mapped; a bf16 one stays its ``uint16`` bit-view, which
        :meth:`device_gallery` views as bf16 on upload."""
        dev = resolve_device(device)
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            m = z["m"] if z["m"].size else None
            P = z["P"] if z["P"].size else None
            ids = z["ids"] if z["ids"].size else None
            if meta.get("external_gallery"):
                gpath = os.path.join(os.path.dirname(os.path.abspath(path)),
                                     meta["external_gallery"])
                gallery = np.load(gpath, mmap_mode="r")
            else:
                gallery = z["gallery"]
        if meta.get("gallery_dtype") == "bfloat16":
            if gallery.dtype != np.uint16:
                raise ValueError(f"a bf16 gallery must be saved as uint16 bits, got "
                                 f"{gallery.dtype}")
        elif meta.get("gallery_dtype"):
            raise ValueError(f"unsupported gallery dtype {meta['gallery_dtype']!r}")
        return cls(
            gallery=gallery, m=m, P=P, dims=meta.get("dims"), ids=ids,
            storage=meta.get("storage", "float32"), device=dev,
        )
