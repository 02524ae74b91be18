"""Port parity: cluster-sharded IVF (``parallel.sharded_ivf``) and
row-sharded PQ (``parallel.sharded_pq``) on an 8-shard CPU mesh, each held
against its JAX twin on the 8 virtual devices (tests/conftest.py) and
against the port's own single-device index: identical indices.

The indexes are built once by the JAX package and loaded by the port, so
both search the same partitions and codebooks.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from irtpu.parallel.mesh import create_mesh as j_create_mesh
from irtpu.parallel.sharded_ivf import ShardedIVF as JShardedIVF
from irtpu.parallel.sharded_pq import ShardedPQ as JShardedPQ
from irtpu.retrieval.ivf import IVFIndex as JIVFIndex
from irtpu.retrieval.pq import PQIndex as JPQIndex

from image_retrieval_for_image_based_localization_tpu_torch.parallel import (
    ShardedIVF,
    create_mesh,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.sharded_pq import ShardedPQ
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.ivf import IVFIndex
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import knn_search
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.pq import PQIndex
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(devices=["cpu"] * 8)


def _corpus(n=1500, d=32, n_modes=12, seed=0):
    """Clustered unit rows (the JAX package's tests/test_sharded_ivf.py corpus, smaller)."""
    rng = np.random.RandomState(seed)
    modes = rng.randn(n_modes, d).astype(np.float32) * 4.0
    g = modes[rng.randint(n_modes, size=n)] + rng.randn(n, d).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = modes[rng.randint(n_modes, size=16)] + rng.randn(16, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return g.astype(np.float32), q.astype(np.float32)


def _equal_but_for_ulp_ties(i, s, ji, js, tol=1e-6):
    """Indices equal to the JAX package's, except where two rows' scores tie
    within ``tol``: torch's and XLA's f32 dot products sum in other orders,
    so a pair one package scores equal can be an ulp apart in the other
    (k past the probed rows lists whole clusters, deep near-ties included;
    ROADMAP C4). Every swapped row must sit at a place whose JAX score is
    within ``tol`` of the port's."""
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-5)
    for a, b in np.argwhere(i != ji):
        b2 = int(np.flatnonzero(ji[a] == i[a, b])[0])
        assert abs(js[a, b2] - s[a, b]) <= tol and abs(js[a, b] - s[a, b]) <= tol, (a, b, b2)


@pytest.fixture(scope="module", params=["f32", "bf16", "int8"])
def ivf_pair(request, tmp_path_factory):
    """(gallery, queries, port IVF, JAX IVF) with 13 clusters: 3 pad
    clusters on the 8-shard mesh."""
    g, q = _corpus(seed=3)
    j = JIVFIndex.build(g, n_clusters=13, dtype=request.param)
    path = str(tmp_path_factory.mktemp("ivf") / "ivf.npz")
    j.save(path)
    return g, q, IVFIndex.load(path, device="cpu"), j


@pytest.mark.parametrize("nprobe,k", [(2, 10), (5, 10), (13, 10), (1, 5000)])
def test_sharded_ivf_matches_single_device_and_jax(mesh, ivf_pair, nprobe, k):
    g, q, ivf, jivf = ivf_pair
    sh = ShardedIVF(ivf, mesh=mesh)
    assert sh.n_clusters == 16 and all(s[2].shape == (2,) for s in sh.shards)
    s, i = sh.search(q, k=k, nprobe=nprobe)
    s1, i1 = ivf.search(q, k=k, nprobe=nprobe)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_allclose(s, s1, rtol=0, atol=1e-6)
    js, ji = JShardedIVF(jivf, mesh=j_create_mesh([1, 8])).search(q, k=k, nprobe=nprobe)
    _equal_but_for_ulp_ties(i, s, np.asarray(ji), np.asarray(js))
    if k > len(g):  # k above the probed rows: fill slots are row -1, never a fabricated id
        assert (i == -1).any() and (s[i == -1] < -1e30).all()
        real = i[i >= 0]
        assert len(np.unique(i[0][i[0] >= 0])) == (i[0] >= 0).sum() and real.max() < len(g)


def test_sharded_ivf_full_probe_is_exact(mesh, ivf_pair):
    """nprobe = C is exact search over the gallery stored as the partitions
    store it (bf16, or int8 as the symmetric x127 quantization)."""
    g, q, ivf, _ = ivf_pair
    s, i = ShardedIVF(ivf, mesh=mesh).search(q, k=10, nprobe=13)
    gt = torch.from_numpy(g)
    gt = {"f32": gt, "bf16": gt.to(torch.bfloat16),
          "int8": torch.clamp(torch.round(gt * 127.0), -127, 127).to(torch.int8)}[ivf.dtype]
    s1, i1 = knn_search(gt, torch.from_numpy(q), 10)
    np.testing.assert_array_equal(i, i1.numpy())
    np.testing.assert_allclose(s, s1.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def pq_pair(tmp_path_factory):
    rng = np.random.RandomState(11)
    base = rng.randn(160, 64).astype(np.float32)
    g = np.concatenate([base, base[:13], rng.randn(160, 64).astype(np.float32)])  # 333 rows
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[rng.choice(len(g), 16, replace=False)] + 0.05 * rng.randn(16, 64).astype(np.float32)
    j = JPQIndex.build(g, m=8)
    path = str(tmp_path_factory.mktemp("pq") / "pq.npz")
    j.save(path)
    return g, q, PQIndex.load(path, device="cpu"), j


@pytest.mark.parametrize("refine", [0, 40, 333])
def test_sharded_pq_matches_single_device_and_jax(mesh, pq_pair, refine):
    g, q, pq, jpq = pq_pair
    gal = g if refine else None
    spq = ShardedPQ(pq, mesh=mesh)
    assert all(c.shape == (42, 8) for c in spq.codes)  # 333 rows padded to 8 x 42
    s, i = spq.search(q, k=10, refine=refine, gallery=gal)
    s1, i1 = pq.search(q, k=10, refine=refine, gallery=gal)
    np.testing.assert_array_equal(i, i1)
    if refine:
        np.testing.assert_allclose(s, s1, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(s, s1)   # the ADC scores, bit for bit
    jmesh = JMesh(np.array(jax.devices()[:8]), ("gallery",))
    js, ji = JShardedPQ(jpq, mesh=jmesh).search(q, k=10, refine=refine, gallery=gal)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-5)
    if refine == len(g):  # refinement over every row is exact search
        _, ie = knn_search(torch.from_numpy(g), torch.from_numpy(q), 10)
        np.testing.assert_array_equal(i, ie.numpy())


def test_sharded_pq_tie_contract(mesh):
    """Every row duplicated across shard borders: the lower global row wins."""
    rng = np.random.RandomState(3)
    base = rng.randn(40, 32).astype(np.float32)
    g = np.concatenate([base, base])
    pq = PQIndex.build(g, m=4, device="cpu")
    s, i = ShardedPQ(pq, mesh=mesh).search(base[:6], k=12)
    s1, i1 = pq.search(base[:6], k=12)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_array_equal(s, s1)
    assert (i[:, 0] < 40).all()  # a row's code twin at +40 ranks after it
    with pytest.raises(ValueError, match="refine requires"):
        ShardedPQ(pq, mesh=mesh).search(base[:2], k=3, refine=10)
