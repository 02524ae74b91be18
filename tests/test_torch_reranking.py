"""Port parity: the re-ranking family against the JAX package on the same
seeded inputs: αQE and DBA (``retrieval.query_expansion``, ``Index.build(
dba_nqe)``), kNN-graph diffusion (``retrieval.diffusion``,
``Index.diffusion_ranks``) and ``Index.query(method="approx")``.

The clustered corpus is tests/test_query_expansion.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irtpu.parallel import ShardedIndex as JShardedIndex
from irtpu.parallel import create_mesh as j_create_mesh
from irtpu.retrieval.diffusion import build_graph as j_build_graph
from irtpu.retrieval.diffusion import diffusion_scores as j_diffusion_scores
from irtpu.retrieval.index import Index as JIndex
from irtpu.retrieval.query_expansion import expand_queries as j_expand
from irtpu.retrieval.query_expansion import expand_queries_host as j_expand_host
from irtpu.retrieval.query_expansion import expand_via_sharded as j_expand_via_sharded
from irtpu.utils.config import IndexConfig as JIndexConfig

from image_retrieval_for_image_based_localization_tpu_torch.parallel import (
    ShardedIndex,
    create_mesh,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval import index as index_mod
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.diffusion import (
    build_graph,
    diffuse,
    diffusion_scores,
    graph_from_knn,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import knn_search
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.query_expansion import (
    expand_queries,
    expand_queries_host,
    expand_via_sharded,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import IndexConfig

from test_query_expansion import _clustered
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


@pytest.fixture(scope="module")
def corpus():
    return _clustered(noise=0.3)


def _int8(g):
    return np.clip(np.round(g * 127.0), -127, 127).astype(np.int8)


@pytest.mark.parametrize("alpha", [3.0, 0.0])
@pytest.mark.parametrize("storage", ["float32", "int8", "bfloat16"])
def test_expand_queries_matches_jax(corpus, storage, alpha):
    g, _, q, _ = corpus
    tg, jg = torch.from_numpy(g), jnp.asarray(g)
    if storage == "int8":
        tg, jg = torch.from_numpy(_int8(g)), jnp.asarray(_int8(g))
    elif storage == "bfloat16":
        tg = tg.to(torch.bfloat16)
        jg = jnp.asarray(tg.float().numpy(), jnp.bfloat16)
    got = expand_queries(tg, torch.from_numpy(q), nqe=10, alpha=alpha)
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = np.asarray(j_expand(jg, jnp.asarray(q), nqe=10, alpha=alpha))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


def test_expand_host_and_negative_scores(corpus):
    g, _, q, _ = corpus
    rng = np.random.RandomState(0)
    rows, sc = rng.randn(4, 5, 64).astype(np.float32), rng.randn(4, 5).astype(np.float32)
    np.testing.assert_allclose(expand_queries_host(rows, q[:4], sc),
                               j_expand_host(rows, q[:4], sc), rtol=0, atol=1e-6)
    # anti-correlated neighbours are clipped to weight 0, not subtracted
    qo = np.linalg.qr(rng.randn(16, 2))[0].T.astype(np.float32)
    got = expand_queries(torch.from_numpy(np.concatenate([qo, -qo])), torch.from_numpy(qo),
                         nqe=4)
    np.testing.assert_allclose(got.numpy(), qo, atol=1e-5)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_index_qe_query_and_ranks_match_jax(corpus, storage):
    g, _, q, _ = corpus
    t = Index.build(g, IndexConfig(whitening="pca", storage=storage), device="cpu")
    j = JIndex.build(g, JIndexConfig(whitening="pca", storage=storage))
    for k in (5, 200):  # k > 128 with or without QE runs knn_search
        s, i = t.query(q, k=k, qe_nqe=7, qe_alpha=2.0)
        js, ji = j.query(q, k=k, qe_nqe=7, qe_alpha=2.0)
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t.ranks(q, qe_nqe=7), j.ranks(q, qe_nqe=7))


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_dba_matches_jax_and_blocks_change_nothing(corpus, storage, monkeypatch):
    g, _, q, _ = corpus
    cfg = IndexConfig(whitening="pca", dba_nqe=5, dba_alpha=3.0, storage=storage)
    t = Index.build(g, cfg, device="cpu")
    j = JIndex.build(g, JIndexConfig(whitening="pca", dba_nqe=5, dba_alpha=3.0,
                                     storage=storage))
    np.testing.assert_allclose(t.gallery, np.asarray(j.gallery), rtol=0, atol=1e-5)
    _, i = t.query(q, k=20)
    _, ji = j.query(q, k=20)
    np.testing.assert_array_equal(i, np.asarray(ji))
    monkeypatch.setattr(index_mod, "DBA_BLOCK", 7)   # 192 rows in 28 blocks
    np.testing.assert_array_equal(Index.build(g, cfg, device="cpu").gallery, t.gallery)


def test_expand_via_sharded_equals_dense_qe(corpus):
    g, _, q, _ = corpus
    g2 = np.concatenate([g, g[:40]])   # duplicates across the shards' borders
    t = Index.build(g2, IndexConfig(whitening="pca"), device="cpu")
    si = ShardedIndex.from_index(t, mesh=create_mesh(devices=["cpu"] * 8))
    qx = expand_via_sharded(si, t.gallery, q, nqe=6, alpha=3.0)
    dense = expand_queries(t.device_gallery(), t.transform_queries(q), nqe=6).numpy()
    np.testing.assert_allclose(qx, dense, rtol=0, atol=1e-6)
    j = JIndex.build(g2, JIndexConfig(whitening="pca"))
    jx = j_expand_via_sharded(JShardedIndex.from_index(j, mesh=j_create_mesh([1, 8])),
                              j.gallery, q, nqe=6, alpha=3.0)
    np.testing.assert_allclose(qx, np.asarray(jx), rtol=0, atol=1e-5)
    _, i = si.query(qx, k=30, pre_transformed=True)
    _, i1 = t.query(q, k=30, qe_nqe=6)
    np.testing.assert_array_equal(i, i1)


def test_approx_method_is_the_exact_search(corpus):
    g, _, q, _ = corpus
    t = Index.build(g, IndexConfig(whitening=None), device="cpu")
    for k in (10, 150):
        np.testing.assert_array_equal(t.query(q, k=k, method="approx", recall_target=0.5)[1],
                                      t.query(q, k=k)[1])
    with pytest.raises(ValueError, match="recall_target"):
        t.query(q, k=3, method="approx", recall_target=0.0)
    with pytest.raises(ValueError, match="unknown query method"):
        t.query(q, k=3, method="hnsw")


def _dense_S(src, dst, w, n):
    S = np.zeros((n, n), np.float64)
    np.add.at(S, (np.asarray(dst), np.asarray(src)), np.asarray(w, np.float64))
    return S


@pytest.fixture(scope="module")
def graphs(corpus):
    g = corpus[0]
    return build_graph(torch.from_numpy(g), k=8), j_build_graph(jnp.asarray(g), k=8)


def test_graph_matches_jax(graphs):
    t, j = graphs
    assert t.n == j.n and t.src.shape == j.src.shape
    S = _dense_S(t.src, t.dst, t.w, t.n)
    np.testing.assert_allclose(S, _dense_S(j.src, j.dst, j.w, j.n), rtol=0, atol=1e-6)
    np.testing.assert_allclose(S, S.T, atol=1e-6)
    assert np.abs(np.diag(S)).max() == 0.0
    # sorted by destination, offsets delimit each destination's edges
    assert (torch.diff(t.dst) >= 0).all() and t.offsets[-1] == len(t.dst)
    np.testing.assert_array_equal(torch.bincount(t.dst, minlength=t.n).numpy(),
                                  torch.diff(t.offsets).numpy())


def test_graph_from_knn_lists_is_build_graph(corpus, graphs):
    # the graph's arithmetic alone, on lists made elsewhere (the card's, in
    # chip_smoke.py's card-vs-CPU check): bit for bit build_graph's
    t, _ = graphs
    s, i = knn_search(torch.from_numpy(corpus[0]), torch.from_numpy(corpus[0]), k=9)
    got = graph_from_knn(s, i, gamma=3.0)
    assert got.n == t.n
    for a in ("src", "dst", "w", "offsets"):
        assert torch.equal(getattr(got, a), getattr(t, a)), a


def test_diffusion_scores_match_jax_and_direct_solve(corpus, graphs):
    g, _, q, _ = corpus
    t, j = graphs
    f = diffusion_scores(torch.from_numpy(g), torch.from_numpy(q), graph=t, k_seed=5)
    jf = np.asarray(j_diffusion_scores(jnp.asarray(g), jnp.asarray(q), graph=j, k_seed=5))
    assert f.shape == (len(g), len(q))
    assert np.abs(f - jf).max() <= 1e-5 * np.abs(jf).max()
    y = np.abs(np.random.RandomState(0).randn(t.n, 3)).astype(np.float32)
    direct = np.linalg.solve(np.eye(t.n) - 0.9 * _dense_S(t.src, t.dst, t.w, t.n), y)
    got = diffuse(t, torch.from_numpy(y), alpha=0.9, iters=60).numpy()
    np.testing.assert_allclose(got, direct, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_diffusion_ranks_match_jax(corpus, storage):
    g, gl, q, ql = corpus
    t = Index.build(g, IndexConfig(whitening=None, storage=storage), device="cpu")
    j = JIndex.build(g, JIndexConfig(whitening=None, storage=storage))
    r = t.diffusion_ranks(q, k_graph=10, k_seed=5)
    np.testing.assert_array_equal(r, j.diffusion_ranks(q, k_graph=10, k_seed=5))
    assert list(t._diffusion_cache) == [(10, 3.0)]
    graph = t._diffusion_cache[(10, 3.0)]
    np.testing.assert_array_equal(t.diffusion_ranks(q, k_graph=10, k_seed=5), r)  # repeats
    assert t._diffusion_cache[(10, 3.0)] is graph                                # cached
    rq = t.diffusion_ranks(q, k_graph=10, k_seed=5, qe_nqe=3)
    np.testing.assert_array_equal(rq, j.diffusion_ranks(q, k_graph=10, k_seed=5, qe_nqe=3))
    # on the clustered corpus diffusion beats plain cosine ranking
    def mean_ap(ranks):
        aps = []
        for c in range(len(q)):
            hits = np.flatnonzero(gl[ranks[:, c]] == ql[c])
            aps.append(np.mean((np.arange(len(hits)) + 1) / (hits + 1)))
        return np.mean(aps)
    assert mean_ap(r) > mean_ap(t.ranks(q)) + 0.1


def test_duplicate_rows_drop_self_not_a_neighbour():
    """Row 1 duplicates row 0: its first neighbour is row 0 (lower index on
    the tie), and the dropped edge must be its self-edge, not row 0."""
    rng = np.random.RandomState(1)
    g = rng.randn(12, 16).astype(np.float32)
    g[1] = g[0]
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    t = build_graph(torch.from_numpy(g), k=3)
    S = _dense_S(t.src, t.dst, t.w, t.n)
    assert np.abs(np.diag(S)).max() == 0.0 and S[0, 1] > 0 and S[1, 0] > 0
    j = j_build_graph(jnp.asarray(g), k=3)
    np.testing.assert_allclose(S, _dense_S(j.src, j.dst, j.w, j.n), rtol=0, atol=1e-6)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_unreached_rows_fall_back_to_cosine_below_reached(storage):
    rng = np.random.RandomState(0)
    a = np.linalg.qr(rng.randn(8, 8))[0].astype(np.float32)
    w = np.array([1.0, 0.9, 0.8, 0.7], np.float32)[:, None]
    comp_a = w * a[0] + (1 - w) * a[1]
    comp_b = w * a[4] + (1 - w) * a[5]
    g = np.concatenate([comp_a, comp_b])
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[:1] + 0.2 * a[4:5] - 0.3 * a[5:6]   # component A; B at distinct small cosines
    t = Index.build(g, IndexConfig(whitening=None, storage=storage), device="cpu")
    ranks = t.diffusion_ranks(q, k_graph=2, k_seed=2)[:, 0]
    pos = {int(r): n for n, r in enumerate(ranks)}
    assert max(pos[i] for i in range(4)) < min(pos[i] for i in range(4, 8))
    cos_b = t.ranks(q)[:, 0]                      # B keeps its (dequantized) cosine order
    assert [r for r in ranks if r >= 4] == [r for r in cos_b if r >= 4]
    j = JIndex.build(g, JIndexConfig(whitening=None, storage=storage))
    np.testing.assert_array_equal(ranks, j.diffusion_ranks(q, k_graph=2, k_seed=2)[:, 0])
