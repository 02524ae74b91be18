"""Port parity for PQ, OPQ, IVF-PQ and OPQ-IVF-PQ: artifacts built and saved
by the JAX package load in the port (``load_pq_artifact``) and search to
identical rows, scores within 1e-5, refine on and off, at nprobe 1, C/8 and
C, under-filled probes included; the port's artifacts load in the JAX
package; the port's build gives the JAX codes from the JAX k-means init;
and the JAX suite's own PQ properties hold on the port (CPU)."""

import numpy as np
import pytest
import torch

from irtpu.retrieval.ivf import IVFIndex as JIVF
from irtpu.retrieval.pq import IVFPQIndex as JIVFPQ
from irtpu.retrieval.pq import PQIndex as JPQ
from irtpu.retrieval.pq import _opq_pca_permutation_init as j_opq_init
from irtpu.retrieval.pq import load_pq_artifact as j_load_pq_artifact

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.retrieval import pq as pq_mod
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import knn_search

from test_torch_ivf import clustered, jax_init_kmeans
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

C = 16


def _corpus(seed=0, n=800):
    return clustered(n=n, d=32, seed=seed)


def _aniso(n=600, d=32, seed=0):
    """Anisotropic spectrum under a random rotation: where OPQ helps."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(d, d))
    return ((rng.randn(n, d) * np.sqrt(1.0 / np.arange(1, d + 1))) @ Q).astype(np.float32)


def _check_same(t, j, q, g, **kw):
    ts, ti = t.search(q, gallery=g, **kw)
    js, ji = j.search(q, gallery=g, **kw)
    np.testing.assert_array_equal(ti, np.asarray(ji), err_msg=str(kw))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-5)
    return ts, ti


@pytest.mark.parametrize("opq_iters", [0, 3], ids=["pq", "opq"])
def test_jax_built_pq_searches_identically(opq_iters, tmp_path):
    g, q = _corpus()
    j = JPQ.build(g, m=8, opq_iters=opq_iters)
    j.save(str(tmp_path / "j.pq.npz"))
    t = port.load_pq_artifact(str(tmp_path / "j.pq.npz"), device="cpu")
    assert isinstance(t, port.PQIndex) and (t.rotation is None) == (opq_iters == 0)
    for refine in (0, 60):
        for k in (10, 100):
            _check_same(t, j, q, g, k=k, refine=refine)


@pytest.mark.parametrize("opq_iters", [0, 3], ids=["ivfpq", "opq_ivfpq"])
def test_jax_built_ivfpq_searches_identically(opq_iters, tmp_path):
    g, q = _corpus(seed=1)
    j = JIVFPQ.from_ivf(JIVF.build(g, n_clusters=C), m=8, opq_iters=opq_iters)
    j.save(str(tmp_path / "j.ivfpq.npz"))
    t = port.load_pq_artifact(str(tmp_path / "j.ivfpq.npz"), device="cpu")
    assert isinstance(t, port.IVFPQIndex)
    for nprobe in (1, C // 8, C):
        for refine in (0, 40):
            _check_same(t, j, q, g, k=10, nprobe=nprobe, refine=refine)


def test_ivfpq_under_filled_probe(tmp_path):
    g, q = _corpus(seed=11, n=256)
    j = JIVFPQ.from_ivf(JIVF.build(g, n_clusters=32), m=8)
    j.save(str(tmp_path / "j.npz"))
    t = port.IVFPQIndex.load(str(tmp_path / "j.npz"), device="cpu")
    L = t.codes.shape[1]
    for refine in (0, 64):
        s, i = _check_same(t, j, q, g, k=2 * L + 20, nprobe=2, refine=refine)
        fill = s <= np.finfo(np.float32).min / 2
        assert fill.any() and (i[fill] == -1).all()
        for row, real in zip(i, ~fill):
            assert len(set(row[real].tolist())) == int(real.sum())


@pytest.mark.parametrize("kind", ["pq", "opq", "ivfpq", "opq_ivfpq"])
def test_port_saved_artifacts_load_in_jax(kind, tmp_path):
    g, q = _corpus(seed=2)
    opq = 2 if kind.startswith("opq") else 0
    if kind.endswith("ivfpq"):
        t = port.IVFPQIndex.from_ivf(port.IVFIndex.build(g, n_clusters=C, device="cpu"), m=8,
                                     opq_iters=opq, device="cpu")
        kw = {"nprobe": 4, "refine": 30}
    else:
        t = port.PQIndex.build(g, m=8, opq_iters=opq, device="cpu")
        kw = {"refine": 30}
    t.save(str(tmp_path / "t.npz"))
    j = j_load_pq_artifact(str(tmp_path / "t.npz"))
    assert type(j).__name__ == type(t).__name__
    _check_same(t, j, q, g, k=10, **kw)
    _check_same(t, j, q, None, k=10, **{k: v for k, v in kw.items() if k != "refine"})


def test_pq_build_from_jax_init_gives_jax_codes(monkeypatch):
    g, _ = _corpus(seed=3, n=1200)
    monkeypatch.setattr(pq_mod, "kmeans", jax_init_kmeans)
    t = port.PQIndex.build(g, m=8, kmeans_iters=10, device="cpu")
    j = JPQ.build(g, m=8, kmeans_iters=10)
    np.testing.assert_allclose(t.codebooks, j.codebooks, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t.codes, j.codes)


def test_opq_pca_permutation_init_is_bitwise_jax():
    x = _aniso(n=500, d=32, seed=3)
    np.testing.assert_array_equal(pq_mod._opq_pca_permutation_init(x, 8), j_opq_init(x, 8))


# -- the JAX suite's PQ properties (tests/test_pq.py) on the port -----------


def test_adc_tie_contract_lower_row_wins():
    g, q = _corpus(seed=4, n=256)
    g = np.concatenate([g[:128], g[:128]])  # rows i and i + 128 identical
    t = port.PQIndex.build(g, m=8, kmeans_iters=10, device="cpu")
    _, i = t.search(q, k=8)
    recon = pq_mod._decode(t.codebooks, t.codes)
    want = np.argsort(-(q @ recon.T), axis=1, kind="stable")[:, :8]
    np.testing.assert_array_equal(i, want)


def test_refine_equals_exact_when_candidates_cover():
    g, q = _corpus(seed=5, n=512)
    t = port.PQIndex.build(g, m=8, device="cpu")
    s_ex, i_ex = knn_search(torch.from_numpy(g), torch.from_numpy(q), 10)
    s, i = t.search(q, k=10, refine=512, gallery=g)
    np.testing.assert_array_equal(i, i_ex.numpy())
    np.testing.assert_allclose(s, s_ex.numpy(), rtol=0, atol=1e-5)


def test_opq_rotation_orthogonal_and_better_fit():
    x = _aniso(n=2000)
    plain = port.PQIndex.build(x, m=8, device="cpu")
    opq = port.PQIndex.build(x, m=8, opq_iters=6, device="cpu")
    assert opq.rotation is not None and plain.rotation is None
    np.testing.assert_allclose(opq.rotation @ opq.rotation.T, np.eye(32), rtol=0, atol=1e-5)

    def mse(t):
        xr = x if t.rotation is None else x @ t.rotation
        return np.mean(np.sum((xr - pq_mod._decode(t.codebooks, t.codes)) ** 2, axis=1))

    assert mse(opq) < 0.97 * mse(plain), (mse(opq), mse(plain))


def test_ivfpq_rejects_compressed_ivf():
    g, _ = _corpus(n=200)
    with pytest.raises(ValueError, match="f32 partitions"):
        port.IVFPQIndex.from_ivf(port.IVFIndex.build(g, n_clusters=4, dtype="int8",
                                                     device="cpu"), m=8, device="cpu")


def test_backend_values_give_the_same_result():
    g, q = _corpus(seed=6, n=300)
    t = port.PQIndex.build(g, m=4, kmeans_iters=5, device="cpu")
    ref = t.search(q, k=5)
    for backend in ("gather", "mxu"):
        s, i = t.search(q, k=5, backend=backend)
        np.testing.assert_array_equal(i, ref[1])
        np.testing.assert_array_equal(s, ref[0])
    with pytest.raises(ValueError, match="backend"):
        t.search(q, k=5, backend="tpu")
