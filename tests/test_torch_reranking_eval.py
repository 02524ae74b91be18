"""Port parity: ``evaluate_dataset``'s sharded, αQE, diffusion and
``ann="approx"`` branches and ``localize_shortlist`` with re-ranking,
against the JAX package on a toy revisited dataset.

The ranking is what these branches change, so both harnesses get the same
descriptors from a stub extractor (clustered rows, a scene per cluster)
instead of a model: the mAP and the pairs are then the two packages'
rankings alone.
"""

import numpy as np
import pytest

from irtpu import localization as j_loc
from irtpu.data.test_datasets import TestDataset as JTestDataset
from irtpu.evaluation.harness import evaluate_dataset as j_evaluate
from irtpu.parallel import create_mesh as j_create_mesh
from irtpu.retrieval.index import Index as JIndex
from irtpu.utils.config import ExtractConfig as JExtractConfig
from irtpu.utils.config import IndexConfig as JIndexConfig

import torch

from image_retrieval_for_image_based_localization_tpu_torch import localization as loc
from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
    TestDataset as PortDataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.evaluation.harness import (
    evaluate_dataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel import create_mesh
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    ExtractConfig,
    IndexConfig,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

N_SCENES, VIEWS, N_DISTRACT, D = 6, 8, 20, 48


class _Stub:
    """Extractor stand-in: each path's descriptor from a table."""

    device = torch.device("cpu")

    def __init__(self, table):
        self.table = table

    def extract(self, paths, bbxs=None):
        return np.stack([self.table[p] for p in paths])


@pytest.fixture(scope="module")
def toy():
    rng = np.random.RandomState(0)
    centers = rng.randn(N_SCENES, D)
    db, labels = [], []
    for s in range(N_SCENES):
        db.append(centers[s] + 0.9 * rng.randn(VIEWS, D))
        labels += [s] * VIEWS
    db.append(rng.randn(N_DISTRACT, D))
    labels += [-1] * N_DISTRACT
    db = np.concatenate(db)
    db = np.concatenate([db, db[3:5]])   # two duplicated rows
    labels = np.array(labels + labels[3:5])
    qd = centers + 0.9 * rng.randn(N_SCENES, D)
    db = (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)
    qd = (qd / np.linalg.norm(qd, axis=1, keepdims=True)).astype(np.float32)
    gnd = []
    for s in range(N_SCENES):
        pos = np.flatnonzero(labels == s)
        gnd.append({"easy": pos[: len(pos) // 2], "hard": pos[len(pos) // 2 :],
                    "junk": np.flatnonzero(labels == -1)[:2 * (s == 0)]})
    cfg = {"imlist": [f"db{i}" for i in range(len(db))],
           "qimlist": [f"q{i}" for i in range(N_SCENES)], "gnd": gnd}
    ds, jds = PortDataset("toy", cfg, "/nonexistent"), JTestDataset("toy", cfg, "/nonexistent")
    table = dict(zip(ds.image_paths, db)) | dict(zip(ds.query_paths, qd))
    return ds, jds, _Stub(table), db, qd


def _maps(res):
    return [res["results"][p]["map"] for p in ("easy", "medium", "hard")]


CASES = {
    "sharded": dict(use_sharded_index=True),
    "sharded_qe": dict(use_sharded_index=True, qe_nqe=4),
    "qe": dict(qe_nqe=4, qe_alpha=2.0),
    "diffusion": dict(diffusion=True, diffusion_kwargs={"k_graph": 6, "k_seed": 3}),
    "diffusion_qe": dict(diffusion=True, qe_nqe=3, diffusion_kwargs={"k_graph": 6}),
    "approx": dict(ann="approx", ann_kwargs={"recall_target": 0.9}, shortlist_k=30),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluate_dataset_branches_match_jax(toy, case):
    ds, jds, stub, _, _ = toy
    kw = dict(CASES[case])
    icfg = IndexConfig(whitening="pca", dba_nqe=3) if case == "qe" else IndexConfig(whitening="pca")
    jicfg = JIndexConfig(whitening="pca", dba_nqe=3 if case == "qe" else 0)
    t_mesh = create_mesh(devices=["cpu"] * 8) if "sharded" in case else None
    j_mesh = j_create_mesh([1, 8]) if "sharded" in case else None
    res = evaluate_dataset(ds, ExtractConfig(), icfg, extractor=stub, device="cpu", mesh=t_mesh,
                           recall_ks=(1, 5), **kw)
    jres = j_evaluate(jds, JExtractConfig(), jicfg, extractor=stub, mesh=j_mesh,
                      recall_ks=(1, 5), **kw)
    assert _maps(res) == _maps(jres)
    assert res["recall"]["recall"] == jres["recall"]["recall"]
    if case == "sharded":   # the sharded streaming mAP is the dense ranking's
        dense = evaluate_dataset(ds, ExtractConfig(), icfg, extractor=stub, device="cpu")
        assert _maps(res) == _maps(dense)
    if case == "approx":    # the exact shortlist: its mAP is the exact ranking's over K = 30
        assert res["results"]["medium"]["map"] > 0


def test_harness_refusals(toy):
    ds, _, stub, _, _ = toy
    for bad, match in [(dict(diffusion=True, use_sharded_index=True), "drop --sharded"),
                       (dict(ann="approx", ann_kwargs={"nprobe": 2}), "only recall_target"),
                       (dict(ann="approx", qe_nqe=2), "ann evaluation")]:
        with pytest.raises(ValueError, match=match):
            evaluate_dataset(ds, ExtractConfig(), IndexConfig(whitening=None), extractor=stub,
                             device="cpu", **bad)


@pytest.mark.parametrize("kw", [dict(qe_nqe=4), dict(qe_nqe=4, qe_alpha=0.0),
                                dict(diffusion=True), dict(diffusion=True, qe_nqe=2)])
def test_localize_shortlist_reranking_matches_jax(toy, kw, tmp_path):
    _, _, _, db, qd = toy
    t = Index.build(db, IndexConfig(whitening=None), device="cpu")
    j = JIndex.build(db, JIndexConfig(whitening=None))
    qn = [f"q{i}.jpg" for i in range(len(qd))]
    names = [f"db{i}.jpg" for i in range(len(db))]
    pairs, scores = loc.localize_shortlist(t, qd, qn, names, k=7, out_path=str(tmp_path / "t"),
                                           **kw)
    jpairs, jscores = j_loc.localize_shortlist(j, qd, qn, names, k=7,
                                               out_path=str(tmp_path / "j"), **kw)
    assert pairs == jpairs and len(pairs) == 7 * len(qd)
    assert open(tmp_path / "t", "rb").read() == open(tmp_path / "j", "rb").read()
    if kw.get("diffusion"):
        assert scores is None and jscores is None
    else:
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=0, atol=1e-5)
        assert pairs != loc.localize_shortlist(t, qd, qn, names, k=7)[0]  # QE re-ranked
