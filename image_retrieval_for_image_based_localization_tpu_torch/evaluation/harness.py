"""End-to-end evaluation: the JAX package's ``evaluation/harness.py::
evaluate_dataset`` with its dense, diffusion, streaming, sharded and ANN
branches.

Extract database and query descriptors (multi-scale, query bbx crops),
learn/apply whitening, then rank: the whole gallery densely (optionally
αQE-expanded or diffusion re-ranked), candidate ranks streamed over gallery
chunks on a large gallery or over a sharded one, or an ANN shortlist;
compute mAP per protocol, and localization recall@k on request.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from image_retrieval_for_image_based_localization_tpu_torch.api import Extractor
from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
    TestDataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
    candidate_matrix,
    compute_map_and_print,
    compute_map_streaming_and_print,
)
from image_retrieval_for_image_based_localization_tpu_torch.localization import (
    localization_recall,
    localization_recall_from_ranks,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_index import (
    ShardedIndex,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import IVFIndex
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    rank_candidates,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import PQIndex
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.query_expansion import (
    expand_via_sharded,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    ExtractConfig,
    IndexConfig,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.device import DeviceLike
from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import (
    MetricsLogger,
    phase_timer,
)


def _log_provenance(logger, dataset, extract_cfg, device: torch.device, ranking_path: str):
    """One provenance event per evaluation run: which device ran it."""
    cuda = device.type == "cuda"
    logger.log(
        event="provenance",
        dataset=dataset.name,
        backend=device.type,
        device_kind=torch.cuda.get_device_name(device) if cuda else "cpu",
        n_devices=torch.cuda.device_count() if cuda else 1,
        ranking_path=ranking_path,
        arch=extract_cfg.model.arch,
        pooling=extract_cfg.model.pooling,
        dtype=extract_cfg.model.dtype,
        image_size=extract_cfg.image_size,
    )


def _log_map(logger, dataset, results):
    """The mAP itself as a JSONL event (revisited E/M/H or classic)."""
    rec = {"event": "map", "dataset": dataset.name}
    if "medium" in results:
        for proto in ("easy", "medium", "hard"):
            r = results[proto]
            rec[f"map_{proto}"] = float(r["map"])
            rec[f"mp_at_k_{proto}"] = [float(v) for v in np.asarray(r["mprk"])]
    else:
        rec["map"] = float(results["map"])
        rec["mp_at_k"] = [float(v) for v in np.asarray(results["mprk"])]
    logger.log(**rec)


def _log_recall(logger, dataset, recall_ks, *, ranks_all=None, shortlist=None, ranks=None):
    """Localization recall@k from whichever ranking the path has:
    candidate ranks [Nq, C], a shortlist [Nq, K], or dense ranks [N, Nq]."""
    if not recall_ks:
        return None
    if ranks_all is not None:
        rec = localization_recall_from_ranks(ranks_all, dataset.gnd, ks=recall_ks)
    elif shortlist is not None:
        ks = [k for k in recall_ks if k <= shortlist.shape[1]]
        if not ks:
            return None
        rec = localization_recall(shortlist, dataset.gnd, ks=ks)
    else:
        kmax = min(max(recall_ks), ranks.shape[0])
        rec = localization_recall(ranks[:kmax].T, dataset.gnd,
                                  ks=[k for k in recall_ks if k <= kmax])
    pretty = {f"r@{k}": round(v * 100, 2) for k, v in rec["recall"].items()}
    print(f">> {dataset.name}: localization recall {pretty}")
    logger.log(event="localization_recall", dataset=dataset.name, n_queries=rec["n_queries"],
               **{f"r_at_{k}": v for k, v in rec["recall"].items()})
    return rec


def evaluate_dataset(
    dataset: TestDataset,
    extract_cfg: ExtractConfig,
    index_cfg: IndexConfig = IndexConfig(),
    state_dict: Optional[Dict] = None,
    extractor: Optional[Extractor] = None,
    whitening_mP=None,
    device: DeviceLike = "cuda",
    mesh=None,
    use_sharded_index: bool = False,
    qe_nqe: int = 0,
    qe_alpha: float = 3.0,
    diffusion: bool = False,
    diffusion_kwargs: Optional[Dict] = None,
    ann: Optional[str] = None,
    ann_kwargs: Optional[Dict] = None,
    shortlist_k: int = 100,
    logger: Optional[MetricsLogger] = None,
    dense_rank_limit: int = 50_000,
    recall_ks: Optional[Sequence[int]] = None,
) -> Dict:
    """Run the evaluation pipeline on a TestDataset; returns the mAP results
    with the index, both descriptor sets and the recall (None unless
    ``recall_ks`` is given).

    Ranking, in this order:
    - ``use_sharded_index=True`` shards the index over ``mesh``
      (``parallel.ShardedIndex``; default: one shard per local device) and
      ranks the ground truth's candidates by the sharded streaming counts,
      αQE-expanded by ``expand_via_sharded`` when ``qe_nqe > 0``.
    - ``ann="ivf"`` (``ann_kwargs``: ``n_clusters`` and ``IVFIndex.search``'s
      arguments), ``ann="pq"`` (``m``, ``opq_iters``, ``refine`` and
      ``PQIndex.build``'s arguments) or ``ann="approx"`` (``recall_target``
      only: the JAX package's ``lax.approx_max_k``, the TPU's hardware
      selection; the port takes the exact shortlist, which meets any
      target) computes mAP from the top-K shortlist (K = ``shortlist_k``,
      clamped to the gallery) alone: a lower bound of the exact mAP, fill
      rows (-1) matching nothing. It is honoured at every gallery size (the
      JAX harness takes its streaming branch first and ignores ``ann`` above
      ``dense_rank_limit``).
    - A gallery of more than ``dense_rank_limit`` rows, without diffusion,
      is ranked exactly by streaming counts (``retrieval.knn.
      rank_candidates``): only the ground truth's ranks are computed, never
      an ``[Ng, Nq]`` ranking; the mAP is the dense path's.
    - Otherwise the dense ranking ``Index.ranks``, or with ``diffusion=True``
      ``Index.diffusion_ranks`` (``diffusion_kwargs``: k_graph, k_seed,
      gamma, alpha, iters).

    ``qe_nqe > 0`` expands the queries by αQE (``qe_alpha``) before every
    exact ranking. ``recall_ks`` adds localization recall@k
    (``localization``) on each branch. ``logger`` receives phase times, a
    provenance record (device type, card name and count, ranking path), the
    mAP and the recall. As in the JAX package, diffusion refuses the
    sharded index, and ``ann`` refuses QE, diffusion and the sharded index.
    """
    if diffusion and use_sharded_index:
        raise ValueError("diffusion re-ranking needs the dense ranking path (full [N, Nq] "
                         "relevance); drop --sharded")
    if ann and (diffusion or qe_nqe or use_sharded_index):
        raise ValueError("ann evaluation measures the plain approximate "
                         "shortlist; drop --qe/--diffusion/--sharded")
    if ann not in (None, "ivf", "pq", "approx"):
        raise ValueError(f"unknown ann mode {ann!r} (ivf|pq|approx)")
    logger = logger or MetricsLogger()
    ex = extractor or Extractor(extract_cfg, state_dict=state_dict, device=device, mesh=mesh)
    with phase_timer("extract_db", logger, items=dataset.n):
        db = ex.extract(dataset.image_paths)
    with phase_timer("extract_queries", logger, items=dataset.nq):
        qd = ex.extract(dataset.query_paths, bbxs=dataset.query_bbxs)
    with phase_timer("build_index", logger):
        index = Index.build(db, index_cfg, whitening_mP=whitening_mP, device=ex.device)
    out = {"index": index, "db": db, "queries": qd}

    if use_sharded_index:
        sindex = ShardedIndex.from_index(index, mesh=mesh)
        with phase_timer("rank", logger, items=dataset.nq):
            cand = candidate_matrix(dataset.gnd)
            if qe_nqe:
                qx = expand_via_sharded(sindex, index.gallery, qd, qe_nqe, alpha=qe_alpha)
                ranks_all = sindex.rank_candidates(qx, cand, pre_transformed=True)
            else:
                ranks_all = sindex.rank_candidates(qd, cand)
        results = compute_map_streaming_and_print(dataset.name, ranks_all, dataset.gnd)
        path, recall = "sharded-streaming", dict(ranks_all=ranks_all)
    elif ann:
        kw = dict(ann_kwargs or {})
        k_short = min(shortlist_k, index.gallery.shape[0])
        with phase_timer("ann_shortlist", logger, items=dataset.nq):
            qt = index.transform_queries(qd)
            if ann == "ivf":
                art = IVFIndex.build(index.gallery, n_clusters=kw.pop("n_clusters", None),
                                     device=index.device)
                _, idx = art.search(qt, k=k_short, **kw)
            elif ann == "approx":
                rt = kw.pop("recall_target", 0.95)
                if kw:
                    raise ValueError(f"unknown ann kwargs for ann='approx': {sorted(kw)} "
                                     "(only recall_target is accepted)")
                _, idx = index.query(qd, k=k_short, method="approx", recall_target=rt)
            else:
                refine = kw.pop("refine", 0)
                art = PQIndex.build(index.gallery, m=kw.pop("m", None),
                                    opq_iters=kw.pop("opq_iters", 0), device=index.device, **kw)
                _, idx = art.search(qt, k=k_short, refine=refine,
                                    gallery=index.gallery if refine else None)
        idx = np.asarray(idx)
        results = compute_map_and_print(f"{dataset.name} [ann={ann} K={k_short}]", idx.T,
                                        dataset.gnd)
        path, recall = f"ann-{ann}", dict(shortlist=idx)
    elif index.gallery.shape[0] > dense_rank_limit and not diffusion:
        with phase_timer("rank", logger, items=dataset.nq):
            cand = torch.from_numpy(candidate_matrix(dataset.gnd))
            ranks_all = rank_candidates(index.device_gallery(),
                                        index._search_queries(qd, qe_nqe, qe_alpha),
                                        cand).cpu().numpy()
        results = compute_map_streaming_and_print(dataset.name, ranks_all, dataset.gnd)
        path, recall = "streaming", dict(ranks_all=ranks_all)
    else:
        with phase_timer("rank", logger, items=dataset.nq):
            if diffusion:
                ranks = index.diffusion_ranks(qd, qe_nqe=qe_nqe, qe_alpha=qe_alpha,
                                              **(diffusion_kwargs or {}))
            else:
                ranks = index.ranks(qd, qe_nqe=qe_nqe, qe_alpha=qe_alpha)
        results = compute_map_and_print(dataset.name, ranks, dataset.gnd)
        path, recall = "diffusion" if diffusion else "dense", dict(ranks=ranks)
    _log_provenance(logger, dataset, extract_cfg, ex.device, path)
    _log_map(logger, dataset, results)
    out["recall"] = _log_recall(logger, dataset, recall_ks, **recall)
    out["results"] = results
    return out
