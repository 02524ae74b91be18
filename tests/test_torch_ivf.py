"""Port parity for IVF search: indexes built and saved by the JAX package
(f32, bf16, int8) load in the port and search to identical rows (scores
within 1e-5) at nprobe 1, C/8 and C; the port's saved index loads in the JAX
package; with k-means started from the JAX package's init rows the port's
build gives the same partitions; and the JAX suite's own IVF properties
hold on the port (CPU)."""

import numpy as np
import jax
import pytest
import torch

from irtpu.retrieval.ivf import IVFIndex as JIVF

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.retrieval import ivf as ivf_mod
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import knn_search
from image_retrieval_for_image_based_localization_tpu_torch.training import netvlad_init
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

C = 16


def clustered(n=800, d=32, n_modes=16, nq=20, seed=0, spread=3.0):
    """Gaussian modes around random centers; queries are noisy members."""
    rng = np.random.RandomState(seed)
    modes = rng.randn(n_modes, d).astype(np.float32) * spread
    g = modes[rng.randint(n_modes, size=n)] + rng.randn(n, d).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[rng.choice(n, nq, replace=False)] + 0.3 * rng.randn(nq, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return g.astype(np.float32), q.astype(np.float32)


def jax_init_kmeans(x, k, iters=25, generator=None, init=None):
    """The port's kmeans started from the rows the JAX package's init picks
    (``jax.random.choice(PRNGKey(seed), N, (k,), replace=False)``)."""
    rows = np.array(jax.random.choice(jax.random.PRNGKey(generator.initial_seed()),
                                        x.shape[0], shape=(k,), replace=False))
    return netvlad_init.kmeans(x, k, iters=iters, init=x[torch.from_numpy(rows)])


def _exact(g, q, k):
    _, i = knn_search(torch.from_numpy(g), torch.from_numpy(q), k)
    return i.numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_jax_built_index_searches_identically(dtype, tmp_path):
    g, q = clustered()
    j = JIVF.build(g, n_clusters=C, dtype=dtype)
    j.save(str(tmp_path / "j.npz"))
    t = port.IVFIndex.load(str(tmp_path / "j.npz"), device="cpu")
    assert t.dtype == dtype and t.partitions.shape == j.partitions.shape
    for nprobe in (1, C // 8, C):
        js, ji = j.search(q, k=10, nprobe=nprobe)
        ts, ti = t.search(q, k=10, nprobe=nprobe)
        np.testing.assert_array_equal(ti, ji, err_msg=f"nprobe={nprobe}")
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)


def test_under_filled_probe_gives_minus_one_rows(tmp_path):
    g, q = clustered(n=256, seed=14)
    j = JIVF.build(g, n_clusters=32)
    j.save(str(tmp_path / "j.npz"))
    t = port.IVFIndex.load(str(tmp_path / "j.npz"), device="cpu")
    L = t.partitions.shape[1]
    ts, ti = t.search(q, k=2 * L, nprobe=2)
    js, ji = j.search(q, k=2 * L, nprobe=2)
    fill = ts <= np.finfo(np.float32).min / 2
    assert fill.any() and (ti[fill] == -1).all()
    np.testing.assert_array_equal(ti, ji)
    for row, real in zip(ti, ~fill):
        assert len(set(row[real].tolist())) == int(real.sum())


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_port_saved_index_loads_in_jax(dtype, tmp_path):
    g, q = clustered(seed=3)
    t = port.IVFIndex.build(g, n_clusters=C, dtype=dtype, device="cpu")
    t.save(str(tmp_path / "t.npz"))
    j = JIVF.load(str(tmp_path / "t.npz"))
    assert j.dtype == dtype
    np.testing.assert_array_equal(j.row_ids, t.row_ids)
    for nprobe in (1, C):
        ts, ti = t.search(q, k=10, nprobe=nprobe)
        js, ji = j.search(q, k=10, nprobe=nprobe)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)


@pytest.mark.parametrize("balance", [2.0, 1.3, None])
def test_build_from_jax_init_gives_jax_partitions(balance, monkeypatch):
    g, _ = clustered(seed=5)
    monkeypatch.setattr(ivf_mod, "kmeans", jax_init_kmeans)
    t = port.IVFIndex.build(g, n_clusters=C, balance=balance, device="cpu")
    j = JIVF.build(g, n_clusters=C, balance=balance)
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t.lengths, j.lengths)
    np.testing.assert_array_equal(t.row_ids, j.row_ids)
    np.testing.assert_array_equal(t.partitions, j.partitions)


def test_kmeans_matches_jax_from_the_same_init():
    from irtpu.training.netvlad_init import kmeans as j_kmeans

    g, _ = clustered(n=600, d=24, seed=6, spread=4.0)
    cj, aj = j_kmeans(jax.numpy.asarray(g), 12, iters=10, key=jax.random.PRNGKey(3))
    ct, at = jax_init_kmeans(torch.from_numpy(g), 12, iters=10,
                             generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_kmeans_init_comes_from_the_generator():
    g, _ = clustered(n=300, seed=7)
    x = torch.from_numpy(g)
    runs = [netvlad_init.kmeans(x, 8, iters=3, generator=torch.Generator().manual_seed(s))[0]
            for s in (4, 4, 5)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    # an empty cluster keeps its centroid: a far-away init row attracts nothing
    init = torch.cat([x[:3], torch.full((1, x.shape[1]), 100.0)])
    cent, assign = netvlad_init.kmeans(x, 4, iters=2, init=init)
    assert torch.equal(cent[3], init[3]) and not (assign == 3).any()


# -- the JAX suite's IVF properties (tests/test_ivf.py) on the port ----------


def test_full_probe_equals_exact():
    g, q = clustered(n=400, seed=8)
    t = port.IVFIndex.build(g, n_clusters=10, device="cpu")
    s, i = t.search(q, k=10, nprobe=10)
    np.testing.assert_array_equal(i, _exact(g, q, 10))
    np.testing.assert_allclose(s, np.sort(q @ g.T, axis=1)[:, ::-1][:, :10], rtol=0, atol=1e-5)


def test_pad_rows_never_returned():
    rng = np.random.RandomState(3)
    base = rng.randn(12, 16).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    q = -base[:2]
    t = port.IVFIndex.build(base, n_clusters=4, device="cpu")
    s, i = t.search(q, k=10, nprobe=4)
    assert (s < 0).any()
    for row in i:
        assert len(set(row.tolist())) == 10 and ((row >= 0) & (row < 12)).all()
    np.testing.assert_array_equal(i, _exact(base, q, 10))


def test_balanced_build_bounds_pad_ratio():
    rng = np.random.RandomState(0)
    big = rng.randn(300, 16) * 0.05 + rng.randn(16)  # 75% in one mode
    g = np.concatenate([big, rng.randn(100, 16)]).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[:8] + 0.01
    nat = port.IVFIndex.build(g, n_clusters=8, balance=None, device="cpu")
    bal = port.IVFIndex.build(g, n_clusters=8, balance=1.3, device="cpu")
    assert bal.pad_ratio <= 1.3 + 1e-6 < nat.pad_ratio
    for t in (nat, bal):
        np.testing.assert_array_equal(t.search(q, k=10, nprobe=8)[1], _exact(g, q, 10))


def test_chunk_invariance():
    g, q = clustered(n=300, d=24, seed=9)
    t = port.IVFIndex.build(g, n_clusters=9, device="cpu")
    s1, i1 = t.search(q, k=5, nprobe=4, chunk=3)
    s2, i2 = t.search(q, k=5, nprobe=4, chunk=64)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=0, atol=1e-6)


def test_bad_dtype_raises():
    g, _ = clustered(n=50)
    with pytest.raises(ValueError, match="f32/bf16/int8"):
        port.IVFIndex.build(g, n_clusters=4, dtype="f16", device="cpu")
