"""Port parity: ``localization.py`` (the shortlist hand-off to a pose
solver) against the JAX package's, on the same inputs."""

import numpy as np
import pytest
import torch

from irtpu import localization as jloc
from irtpu.retrieval.index import Index as JIndex
from irtpu.retrieval.knn import rank_candidates as j_rank_candidates
from irtpu.utils.config import IndexConfig as JIndexConfig

from image_retrieval_for_image_based_localization_tpu_torch import localization as loc
from image_retrieval_for_image_based_localization_tpu_torch.evaluation.map import (
    candidate_matrix,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    rank_candidates,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import IndexConfig
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


def _setup(seed=0, n_db=60, nq=7, d=16):
    rng = np.random.RandomState(seed)
    g = rng.randn(n_db, d).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = (g[rng.choice(n_db, nq, replace=False)] + 0.4 * rng.randn(nq, d)).astype(np.float32)
    idx = np.argsort(-(q @ g.T), axis=1, kind="stable")
    return rng, g, q, idx


def _gnd(rng, n_db, nq, revisited):
    gnd = []
    for i in range(nq):
        perm = rng.permutation(n_db)
        if revisited:
            gnd.append({"easy": perm[:2], "hard": perm[2:4] if i % 3 else [],
                        "junk": perm[4:6]})
        else:
            gnd.append({"ok": perm[:3] if i != 2 else [], "junk": perm[3:5]})
    return gnd


def test_retrieval_pairs_and_pairs_file_byte_equal(tmp_path):
    _, g, q, idx = _setup()
    qn = [f"query/q{i}.jpg" for i in range(len(q))]
    dn = [f"db/d{i}.jpg" for i in range(len(g))]
    assert loc.retrieval_pairs(qn, dn, idx[:, :5]) == jloc.retrieval_pairs(qn, dn, idx[:, :5])
    a = loc.write_pairs_file(str(tmp_path / "t" / "pairs.txt"), qn, dn, idx[:, :20])
    b = jloc.write_pairs_file(str(tmp_path / "j" / "pairs.txt"), qn, dn, idx[:, :20])
    assert open(a, "rb").read() == open(b, "rb").read()
    assert len(open(a).read().splitlines()) == len(q) * 20


@pytest.mark.parametrize("revisited", [True, False])
@pytest.mark.parametrize("protocol", ["easy", "medium", "hard"])
def test_localization_recall_matches_jax(revisited, protocol):
    rng, g, q, idx = _setup(seed=1)
    gnd = _gnd(rng, len(g), len(q), revisited)
    ks = (1, 5, 10, 20)
    got = loc.localization_recall(idx[:, :20], gnd, ks=ks, protocol=protocol)
    assert got == jloc.localization_recall(idx[:, :20], gnd, ks=ks, protocol=protocol)
    # the same numbers from streamed candidate ranks (the scale path)
    cand = candidate_matrix(gnd)
    ranks = rank_candidates(torch.from_numpy(g), torch.from_numpy(q),
                            torch.from_numpy(cand)).numpy()
    np.testing.assert_array_equal(ranks, np.asarray(j_rank_candidates(g, q, cand)))
    from_ranks = loc.localization_recall_from_ranks(ranks, gnd, ks=ks, protocol=protocol)
    assert from_ranks == jloc.localization_recall_from_ranks(ranks, gnd, ks=ks,
                                                             protocol=protocol)
    assert from_ranks == got


def test_localization_recall_refusals_match_jax():
    rng, g, q, idx = _setup(seed=2)
    gnd = _gnd(rng, len(g), len(q), True)
    for mod in (loc, jloc):
        with pytest.raises(ValueError, match="depth"):
            mod.localization_recall(idx[:, :5], gnd, ks=(1, 10))
        with pytest.raises(ValueError, match="gnd entries"):
            mod.localization_recall(idx[:3, :20], gnd)
        with pytest.raises(ValueError, match="protocol"):
            mod.localization_recall_from_ranks(np.zeros((len(q), 4), np.int32), gnd,
                                               protocol="hardest")


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_localize_shortlist_matches_jax(storage, tmp_path):
    """End to end on an index of each package, same gallery and whitening:
    identical pairs and byte-equal pairs files."""
    _, g, q, _ = _setup(seed=3, n_db=80, nq=5, d=24)
    qn = [f"q{i}" for i in range(len(q))]
    t_index = Index.build(g, IndexConfig(whitening="pca", storage=storage), device="cpu",
                          ids=[f"img{i}" for i in range(len(g))])
    j_index = JIndex.build(g, JIndexConfig(whitening="pca", storage=storage),
                           ids=[f"img{i}" for i in range(len(g))])
    pt, st = loc.localize_shortlist(t_index, q, qn, k=20, out_path=str(tmp_path / "t.txt"))
    pj, sj = jloc.localize_shortlist(j_index, q, qn, k=20, out_path=str(tmp_path / "j.txt"))
    assert pt == pj and len(pt) == len(q) * 20
    assert pt[0][1].startswith("img")
    assert open(tmp_path / "t.txt", "rb").read() == open(tmp_path / "j.txt", "rb").read()
    np.testing.assert_allclose(st, np.asarray(sj), rtol=0, atol=1e-5)
    names = [f"n{i}" for i in range(len(g))]
    assert (loc.localize_shortlist(t_index, q, qn, db_names=names, k=3)[0]
            == jloc.localize_shortlist(j_index, q, qn, db_names=names, k=3)[0])


def test_localize_shortlist_reranking_is_not_ported():
    """Re-ranking before the cut is ported now: the same pairs as the JAX
    package's (tests/test_torch_reranking_eval.py holds more cases)."""
    _, g, q, _ = _setup(seed=4)
    index = Index.build(g, IndexConfig(whitening=None), device="cpu")
    j_index = JIndex.build(g, JIndexConfig(whitening=None))
    qn = [str(i) for i in range(len(q))]
    for kw in ({"qe_nqe": 2}, {"diffusion": True}):
        assert (loc.localize_shortlist(index, q, qn, k=5, **kw)[0]
                == jloc.localize_shortlist(j_index, q, qn, k=5, **kw)[0])
