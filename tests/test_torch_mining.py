"""Hard-negative mining and the training-tuple dataset: the port's
``training/mining.py`` and ``data/train_dataset.py`` against the JAX
package's on identical descriptors and seeds. Equality is exact: the
candidate filter is NumPy in both, the search is exact with lower-index-wins
ties in both, and the same ``RandomState`` draws come in the same order."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest

from irtpu.data.train_dataset import TuplesDataset as JTuplesDataset
from irtpu.training import mining as jmining

from image_retrieval_for_image_based_localization_tpu_torch.data.train_dataset import (
    TuplesDataset,
    cid_to_filename,
)
from image_retrieval_for_image_based_localization_tpu_torch.training import mining
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


def _pool(seed, n=60, d=16, n_clusters=12):
    rng = np.random.RandomState(seed)
    vecs = rng.randn(n, d).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    clusters = rng.randint(0, n_clusters, n)
    qidxs = rng.choice(n, min(10, n), replace=False)
    pidxs = np.array([(q + 1) % n for q in qidxs])
    return vecs, clusters, qidxs, pidxs


def _same(a, b):
    for f in ("qidxs", "pidxs", "nidxs"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), f)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_clusters", [True, False])
def test_filter_candidates_is_bit_equal_to_jax(seed, with_clusters):
    rng = np.random.RandomState(seed)
    nq, k, n = 17, 40, 90
    cand = np.stack([rng.permutation(n)[:k] for _ in range(nq)]).astype(np.int64)
    qidxs = rng.randint(0, n, nq)
    pidxs = rng.randint(0, n, nq)
    cand[:, 3] = qidxs  # the query and its positive among the candidates
    cand[:, 7] = pidxs
    clusters = rng.randint(0, 9, n) if with_clusters else None  # many repeats per row
    got = mining._filter_candidates(cand, qidxs, pidxs, clusters, 5)
    want = jmining._filter_candidates(cand, qidxs, pidxs, clusters, 5)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["all_rows", "neg_pool", "no_clusters"])
def test_mine_hard_negatives_matches_jax(case):
    vecs, clusters, qidxs, pidxs = _pool(3)
    kw = dict(n_neg=5, pool_topk=30, seed=4)
    if case == "neg_pool":
        kw["neg_pool"] = np.sort(np.random.RandomState(5).choice(60, 25, replace=False))
    cl = None if case == "no_clusters" else clusters
    got = mining.mine_hard_negatives(vecs, qidxs, pidxs, clusters=cl, device="cpu", **kw)
    want = jmining.mine_hard_negatives(vecs, qidxs, pidxs, clusters=cl, **kw)
    _same(got, want)
    assert (got.nidxs >= 0).all()
    if cl is not None:
        assert (clusters[got.nidxs] != clusters[qidxs][:, None]).all()


def test_degenerate_pool_filler_and_raise_match_jax():
    """A pool too small for n_neg: the RandomState filler and the fallback
    scan fill the same rows; a pool of only the query and its positive
    raises in both."""
    vecs, clusters, _, _ = _pool(6, n=8)
    qidxs, pidxs = np.array([0, 2]), np.array([1, 3])
    kw = dict(clusters=clusters, n_neg=5, pool_topk=8, seed=7, neg_pool=np.array([0, 1, 4]))
    got = mining.mine_hard_negatives(vecs, qidxs, pidxs, device="cpu", **kw)
    want = jmining.mine_hard_negatives(vecs, qidxs, pidxs, **kw)
    _same(got, want)
    with pytest.raises(ValueError, match="only the query and its positive"):
        mining.mine_hard_negatives(vecs[:2], [0], [1], n_neg=2, device="cpu")
    with pytest.raises(ValueError, match="only the query and its positive"):
        jmining.mine_hard_negatives(vecs[:2], [0], [1], n_neg=2)


@pytest.mark.parametrize("qsize,poolsize", [(None, None), (6, 30)])
def test_mine_epoch_tuples_matches_jax(qsize, poolsize):
    vecs, clusters, qidxs, pidxs = _pool(8)
    paths = [f"im{i}.jpg" for i in range(len(vecs))]
    lookup = {p: v for p, v in zip(paths, vecs)}
    seen = []

    def extract(ps):
        seen.append(list(ps))
        return np.stack([lookup[p] for p in ps])

    kw = dict(clusters=clusters, n_neg=3, pool_topk=20, seed=2, qsize=qsize, poolsize=poolsize)
    got = mining.mine_epoch_tuples(extract, paths, qidxs, pidxs, device="cpu", **kw)
    want = jmining.mine_epoch_tuples(extract, paths, qidxs, pidxs, **kw)
    _same(got, want)
    assert seen[0] == seen[1]  # the same sampled union was extracted
    if poolsize:
        assert len(seen[0]) < len(paths)


def _write_pickle(tmp_path):
    rng = np.random.RandomState(9)
    cids = [f"{rng.randint(16 ** 8):08x}{i:04d}" for i in range(12)]
    db = {split: {"cids": cids, "qidxs": list(range(0, 12, 2)),
                  "pidxs": list(range(1, 12, 2)), "cluster": [i // 4 for i in range(12)]}
          for split in ("train", "val")}
    root = tmp_path / "train" / "retrieval-SfM-120k"
    root.mkdir(parents=True)
    pkl = root / "retrieval-SfM-120k.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(db, f)
    return str(pkl), cids


def test_tuples_dataset_from_pickle_matches_jax(tmp_path):
    pkl, cids = _write_pickle(tmp_path)
    for split in ("train", "val"):
        got = TuplesDataset.from_pickle(pkl, split=split)
        want = JTuplesDataset.from_pickle(pkl, split=split)
        assert got.paths == want.paths and got.name == want.name == split
        for f in ("qidxs", "pidxs", "clusters"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == np.int64
    ims = os.path.join(os.path.dirname(pkl), "ims")
    c = cids[5]
    assert got.paths[5] == cid_to_filename(c, ims) == os.path.join(ims, c[-2:], c[-4:-2],
                                                                     c[-6:-4], c)
    assert len(got) == 6


def test_epoch_tuples_through_an_extractor_matches_jax(tmp_path):
    vecs, clusters, qidxs, pidxs = _pool(10, n=24)
    paths = [f"im{i}.jpg" for i in range(24)]
    lookup = dict(zip(paths, vecs))

    class Ex:
        def extract(self, ps):
            return np.stack([lookup[p] for p in ps])

    ds = TuplesDataset.from_arrays(paths, qidxs, pidxs, clusters)
    jds = JTuplesDataset.from_arrays(paths, qidxs, pidxs, clusters)
    got = ds.epoch_tuples(Ex(), n_neg=2, qsize=5, poolsize=15, seed=3, device="cpu")
    want = jds.epoch_tuples(Ex(), n_neg=2, qsize=5, poolsize=15, seed=3)
    _same(got, want)


def test_search_runs_on_the_given_device_and_returns_host_indices():
    vecs, clusters, qidxs, pidxs = _pool(11)
    ts = mining.mine_hard_negatives(vecs, qidxs, pidxs, clusters=clusters, n_neg=2,
                                    device="cpu")
    assert isinstance(ts.nidxs, np.ndarray) and ts.nidxs.shape == (10, 2)
    # the JAX search over the same rows gives the same candidate order
    from irtpu.retrieval.knn import knn_search as jknn

    _, idx = jknn(jnp.asarray(vecs), jnp.asarray(vecs[qidxs]), k=20)
    want = jmining._filter_candidates(np.asarray(idx, np.int64), qidxs, pidxs, clusters, 2)
    np.testing.assert_array_equal(ts.nidxs, want)
