"""End-to-end evaluation: the dense and ANN branches of the JAX package's
``evaluation/harness.py::evaluate_dataset``.

Extract database and query descriptors (multi-scale, query bbx crops),
learn/apply whitening, rank the whole gallery (or take an IVF/PQ shortlist),
compute mAP per protocol.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor
from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
    TestDataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
    compute_map_and_print,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import IVFIndex
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import PQIndex
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    ExtractConfig,
    IndexConfig,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import DeviceLike


def evaluate_dataset(
    dataset: TestDataset,
    extract_cfg: ExtractConfig,
    index_cfg: IndexConfig = IndexConfig(),
    state_dict: Optional[Dict] = None,
    extractor: Optional[Extractor] = None,
    whitening_mP=None,
    device: DeviceLike = "cuda",
    qe_nqe: int = 0,
    diffusion: bool = False,
    use_sharded_index: bool = False,
    ann: Optional[str] = None,
    ann_kwargs: Optional[Dict] = None,
    shortlist_k: int = 100,
) -> Dict:
    """Run the evaluation pipeline on a TestDataset; returns the mAP results
    with the index and both descriptor sets.

    ``ann="ivf"`` (``ann_kwargs``: ``n_clusters`` and ``IVFIndex.search``'s
    arguments) or ``ann="pq"`` (``m``, ``opq_iters``, ``refine`` and
    ``PQIndex.build``'s arguments) computes mAP from the approximate top-K
    shortlist (K = ``shortlist_k``, clamped to the gallery) alone: a lower
    bound of the exact mAP, fill rows (-1) matching nothing.
    ``ann="approx"`` (the TPU's hardware top-k), ``qe_nqe``, ``diffusion``
    and ``use_sharded_index`` are not ported and raise.
    """
    if ann and (diffusion or qe_nqe or use_sharded_index):
        raise ValueError("ann evaluation measures the plain approximate "
                         "shortlist; drop --qe/--diffusion/--sharded")
    if qe_nqe or diffusion or use_sharded_index:
        raise ValueError("query expansion, diffusion and the sharded index are not ported")
    if ann not in (None, "ivf", "pq"):
        if ann == "approx":
            raise ValueError("ann='approx' (jax.lax.approx_max_k, the TPU's hardware top-k) "
                             "is not ported")
        raise ValueError(f"unknown ann mode {ann!r} (ivf|pq)")
    ex = extractor or Extractor(extract_cfg, state_dict=state_dict, device=device)
    db = ex.extract(dataset.image_paths)
    qd = ex.extract(dataset.query_paths, bbxs=dataset.query_bbxs)
    index = Index.build(db, index_cfg, whitening_mP=whitening_mP, device=ex.device)
    if not ann:
        ranks = index.ranks(qd)
        results = compute_map_and_print(dataset.name, ranks, dataset.gnd)
        return {"results": results, "index": index, "db": db, "queries": qd}

    kw = dict(ann_kwargs or {})
    k_short = min(shortlist_k, index.gallery.shape[0])
    qt = index.transform_queries(qd)
    if ann == "ivf":
        art = IVFIndex.build(index.gallery, n_clusters=kw.pop("n_clusters", None),
                             device=index.device)
        _, idx = art.search(qt, k=k_short, **kw)
    else:
        refine = kw.pop("refine", 0)
        art = PQIndex.build(index.gallery, m=kw.pop("m", None),
                            opq_iters=kw.pop("opq_iters", 0), device=index.device, **kw)
        _, idx = art.search(qt, k=k_short, refine=refine,
                            gallery=index.gallery if refine else None)
    results = compute_map_and_print(f"{dataset.name} [ann={ann} K={k_short}]",
                                    np.asarray(idx).T, dataset.gnd)
    return {"results": results, "index": index, "db": db, "queries": qd}
