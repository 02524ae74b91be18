"""The whole slice against the JAX package: multi-scale extraction over
uint8 buckets -> PCA index -> exact top-k -> full ranks -> revisited mAP,
with the same weights on the same synthetic corpus (CPU). Graded config 2
(resnet + GeM, three scales) and, in small form, graded config 3 (VGG-16 +
NetVLAD, one scale, PCA truncated to ``whiten_dims``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from irtpu.api import Extractor as JExtractor
from irtpu.evaluation.harness import evaluate_dataset as j_evaluate
from irtpu.models.torch_port import port_retrieval_net
from irtpu.retrieval.index import Index as JIndex
from irtpu.utils import config as jcfg

import image_retrieval_for_image_based_localization_tpu_torch as port
from image_retrieval_for_image_based_localization_tpu_torch.api import resize_mask_nearest
from image_retrieval_for_image_based_localization_tpu_torch.data.test_datasets import (
    make_synthetic_dataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.evaluation.harness import (
    evaluate_dataset,
)
from image_retrieval_for_image_based_localization_tpu_torch.models import (
    RetrievalNet,
    init_random_,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)

SCALES = (1.0, 2 ** -0.5, 0.5)


# Path inputs decode through PIL (native_preproc=False) or, on the default,
# through the native library where it builds; both packages take the same
# setting, so each host pipeline is held against the JAX package's.
NATIVE_PREPROC = dict(params=[False, None], ids=["pil", "default"])


@pytest.fixture(scope="module", **NATIVE_PREPROC)
def slice_runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    ds = make_synthetic_dataset(str(root), n_scenes=4, views_per_scene=3,
                                n_distractors=3, image_hw=(72, 96), seed=0)
    net = RetrievalNet("resnet18", "gem")
    init_random_(net, torch.Generator().manual_seed(0))
    sd = net.state_dict()
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(sd, "resnet18"))

    cfg_t = port.ExtractConfig(
        model=port.ModelConfig(arch="resnet18", use_pallas=True),
        image_size=64, scales=SCALES, batch_size=4, native_preproc=request.param)
    ex_t = port.Extractor(cfg_t, state_dict=sd, device="cpu")
    res_t = evaluate_dataset(ds, cfg_t, port.IndexConfig(whitening="pca"),
                             extractor=ex_t, device="cpu")

    cfg_j = jcfg.ExtractConfig(
        model=jcfg.ModelConfig(arch="resnet18", use_pallas=True),
        image_size=64, scales=SCALES, batch_size=4, native_preproc=request.param)
    ex_j = JExtractor(cfg_j, variables=variables)
    res_j = j_evaluate(ds, cfg_j, jcfg.IndexConfig(whitening="pca"), extractor=ex_j)
    return res_t, res_j


def test_descriptors_match(slice_runs):
    res_t, res_j = slice_runs
    for key in ("db", "queries"):
        np.testing.assert_allclose(res_t[key], res_j[key], rtol=0, atol=2e-4)
        np.testing.assert_allclose(np.linalg.norm(res_t[key], axis=1), 1.0, atol=1e-5)


def test_query_indices_identical(slice_runs):
    res_t, res_j = slice_runs
    s_t, i_t = res_t["index"].query(res_t["queries"], k=10)
    _, i_j = res_j["index"].query(res_j["queries"], k=10)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    # Scores are compared on one set of descriptors: this gallery has fewer
    # rows than dims, so PCA's last direction lies in the numerical null
    # space and is set by rounding noise; 2e-4 descriptor differences turn
    # it (and the query norms it enters) into visibly different scores,
    # though never into a different ranking.
    s_jt, i_jt = JIndex.build(res_t["db"], jcfg.IndexConfig(whitening="pca")).query(
        res_t["queries"], k=10)
    np.testing.assert_array_equal(i_t, np.asarray(i_jt))
    np.testing.assert_allclose(s_t, np.asarray(s_jt), rtol=0, atol=1e-5)


def test_ranks_and_map_identical(slice_runs):
    res_t, res_j = slice_runs
    np.testing.assert_array_equal(res_t["index"].ranks(res_t["queries"]),
                                  res_j["index"].ranks(res_j["queries"]))
    for proto in ("easy", "medium", "hard"):
        assert res_t["results"][proto]["map"] == res_j["results"][proto]["map"]
    assert res_t["results"]["medium"]["map"] > 0.5  # clustered corpus retrieves


def test_index_saved_by_one_package_loads_in_the_other(slice_runs, tmp_path):
    res_t, res_j = slice_runs
    res_t["index"].save(str(tmp_path / "t.npz"))
    back_j = JIndex.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back_j.gallery, res_t["index"].gallery)
    np.testing.assert_array_equal(back_j.P, res_t["index"].P)
    res_j["index"].save(str(tmp_path / "j.npz"))
    back_t = Index.load(str(tmp_path / "j.npz"), device="cpu")
    np.testing.assert_array_equal(back_t.gallery, res_j["index"].gallery)
    _, i1 = back_t.query(res_j["queries"], k=5)
    _, i2 = res_j["index"].query(res_j["queries"], k=5)
    np.testing.assert_array_equal(i1, np.asarray(i2))


def test_bf16_gallery_bit_view_loads(tmp_path):
    import ml_dtypes

    rng = np.random.RandomState(0)
    g = rng.randn(50, 16).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    JIndex(gallery=g.astype(ml_dtypes.bfloat16), storage="bfloat16").save(
        str(tmp_path / "b.npz"))
    back = Index.load(str(tmp_path / "b.npz"), device="cpu")
    # held as the uint16 bit-view, never widened to f32 on the host
    assert back.gallery.dtype == np.uint16
    np.testing.assert_array_equal(back.gallery, g.astype(ml_dtypes.bfloat16).view(np.uint16))
    assert back.device_gallery().dtype == torch.bfloat16
    np.testing.assert_array_equal(back.device_gallery().float().numpy(),
                                  g.astype(ml_dtypes.bfloat16).astype(np.float32))
    q = rng.randn(4, 16).astype(np.float32)
    _, i = back.query(q, k=7)
    _, ij = JIndex(gallery=g.astype(ml_dtypes.bfloat16), storage="bfloat16").query(q, k=7)
    np.testing.assert_array_equal(i, np.asarray(ij))


@pytest.mark.parametrize("hw", [(64, 64), (64, 32), (1024, 768), (736, 1024)])
def test_mask_resize_matches_jax_nearest(hw):
    H, W = hw
    rng = np.random.RandomState(1)
    mask = np.zeros((3, H, W), bool)
    for b in range(3):
        mask[b, : rng.randint(1, H + 1), : rng.randint(1, W + 1)] = True
    for s in SCALES[1:]:
        size = (max(int(H * s), 32), max(int(W * s), 32))
        got = resize_mask_nearest(torch.from_numpy(mask), size).numpy()
        want = np.asarray(jax.image.resize(jnp.asarray(mask, jnp.float32),
                                           (3,) + size, "nearest") >= 0.5)
        np.testing.assert_array_equal(got, want)


def test_unmasked_call_matches_jax():
    """Extractor(pixels) without a mask: JAX builds an all-valid mask, the
    port takes the unmasked head; the descriptors agree."""
    net = RetrievalNet("resnet18", "gem")
    init_random_(net, torch.Generator().manual_seed(1))
    sd = net.state_dict()
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(sd, "resnet18"))
    x = np.random.RandomState(2).randn(2, 64, 96, 3).astype(np.float32)
    got = port.Extractor(port.ExtractConfig(
        model=port.ModelConfig(arch="resnet18", use_pallas=True), scales=SCALES),
        state_dict=sd, device="cpu")(x)
    want = JExtractor(jcfg.ExtractConfig(
        model=jcfg.ModelConfig(arch="resnet18", use_pallas=True), scales=SCALES),
        variables=variables)(x)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


# -- graded config 3 in small form: vgg16 + NetVLAD (K=8) at 96 px ----------

C3_DIMS = 8  # whiten_dims: fewer than the gallery's PCA directions, so it truncates


@pytest.fixture(scope="module", **NATIVE_PREPROC)
def config3_runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("synth3")
    ds = make_synthetic_dataset(str(root), n_scenes=3, views_per_scene=3,
                                n_distractors=3, image_hw=(64, 96), seed=1)
    net = RetrievalNet("vgg16", "netvlad", netvlad_clusters=8)
    init_random_(net, torch.Generator().manual_seed(0))
    sd = net.state_dict()
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(sd, "vgg16"))
    g3 = port.GRADED_CONFIGS[3]
    index_cfg = port.IndexConfig(whitening="pca", whiten_dims=C3_DIMS)

    cfg_t = port.ExtractConfig(
        model=port.ModelConfig(arch="vgg16", pooling="netvlad", netvlad_clusters=8,
                               use_pallas=True),
        image_size=96, scales=g3.extract.scales, batch_size=4,
        native_preproc=request.param)
    ex_t = port.Extractor(cfg_t, state_dict=sd, device="cpu")
    res_t = evaluate_dataset(ds, cfg_t, index_cfg, extractor=ex_t, device="cpu")

    cfg_j = jcfg.ExtractConfig(
        model=jcfg.ModelConfig(arch="vgg16", pooling="netvlad", netvlad_clusters=8,
                               use_pallas=True),
        image_size=96, scales=g3.extract.scales, batch_size=4,
        native_preproc=request.param)
    ex_j = JExtractor(cfg_j, variables=variables)
    res_j = j_evaluate(ds, cfg_j, jcfg.IndexConfig(whitening="pca", whiten_dims=C3_DIMS),
                       extractor=ex_j)
    return res_t, res_j


def test_config3_descriptors_match(config3_runs):
    res_t, res_j = config3_runs
    for key in ("db", "queries"):
        assert res_t[key].shape[1] == 8 * 512
        np.testing.assert_allclose(res_t[key], res_j[key], rtol=0, atol=2e-4)
        np.testing.assert_allclose(np.linalg.norm(res_t[key], axis=1), 1.0, atol=1e-5)


def test_config3_query_indices_and_map_identical(config3_runs):
    res_t, res_j = config3_runs
    assert res_t["index"].gallery.shape == (len(res_t["db"]), C3_DIMS)
    assert res_t["index"].P.shape[0] > C3_DIMS  # the truncation is exercised
    _, i_t = res_t["index"].query(res_t["queries"], k=10)
    _, i_j = res_j["index"].query(res_j["queries"], k=10)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    # both indexes built from the same descriptors (see test_query_indices_identical)
    s_jt, i_jt = JIndex.build(
        res_t["db"], jcfg.IndexConfig(whitening="pca", whiten_dims=C3_DIMS)).query(
        res_t["queries"], k=10)
    s_t, i_t = res_t["index"].query(res_t["queries"], k=10)
    np.testing.assert_array_equal(i_t, np.asarray(i_jt))
    np.testing.assert_allclose(s_t, np.asarray(s_jt), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(res_t["index"].ranks(res_t["queries"]),
                                  res_j["index"].ranks(res_j["queries"]))
    for proto in ("easy", "medium", "hard"):
        assert res_t["results"][proto]["map"] == res_j["results"][proto]["map"]


def test_config3_index_at_full_width_round_trips(tmp_path):
    """Config 3's index at its real width: PCA learned on 32,768-d NetVLAD
    descriptors through the dual N < D path, truncated to 4,096 dims (here
    to the N rows the dual path keeps), equal to the JAX index and loadable
    by either package."""
    rng = np.random.RandomState(3)
    db = rng.randn(24, 64 * 512).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    qd = db[:5] + 0.01 * rng.randn(5, 64 * 512).astype(np.float32)
    cfg3 = port.GRADED_CONFIGS[3].index
    t = port.build_index(db, cfg3, device="cpu")
    j = JIndex.build(db, jcfg.GRADED_CONFIGS[3].index)
    assert cfg3.whiten_dims == 4096 and t.P.shape == (24, 64 * 512)
    np.testing.assert_allclose(t.P, j.P, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.gallery, np.asarray(j.gallery), rtol=0, atol=1e-5)
    _, i_t = t.query(qd, k=10)
    _, i_j = j.query(qd, k=10)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    t.save(str(tmp_path / "t.npz"))
    back_j = JIndex.load(str(tmp_path / "t.npz"))
    assert back_j.dims == 4096
    np.testing.assert_array_equal(back_j.P, t.P)
    np.testing.assert_array_equal(np.asarray(back_j.gallery), t.gallery)
    j.save(str(tmp_path / "j.npz"))
    back_t = Index.load(str(tmp_path / "j.npz"), device="cpu")
    assert back_t.dims == 4096
    np.testing.assert_array_equal(back_t.P, np.asarray(j.P))
    _, i_b = back_t.query(qd, k=10)
    np.testing.assert_array_equal(i_b, np.asarray(i_j))


# -- the ANN branch of evaluate_dataset (tests/test_eval_map.py:66-108) ------


@pytest.fixture(scope="module")
def ann_setup(tmp_path_factory):
    ds = make_synthetic_dataset(str(tmp_path_factory.mktemp("annsynth")), n_scenes=4,
                                views_per_scene=4, n_distractors=6, image_hw=(48, 64), seed=2)
    cfg = port.ExtractConfig(model=port.ModelConfig(arch="resnet18"), image_size=64,
                             batch_size=8)
    ex = port.Extractor(cfg, seed=0, device="cpu")
    icfg = port.IndexConfig(whitening=None)
    exact = evaluate_dataset(ds, cfg, icfg, extractor=ex, device="cpu")
    return ds, cfg, ex, icfg, exact


def _map(res):
    return res["results"]["medium"]["map"]


@pytest.mark.parametrize("ann,kw", [("ivf", {"n_clusters": 4, "nprobe": 4}),
                                    ("pq", {"m": 8})])
def test_ann_full_coverage_equals_exact_map(ann_setup, ann, kw):
    """nprobe = C (or refine over the whole gallery) with K = N: the ANN
    shortlist is the exact ranking, so mAP is the exact mAP."""
    ds, cfg, ex, icfg, exact = ann_setup
    kw = dict(kw, refine=ds.n) if ann == "pq" else kw
    full = evaluate_dataset(ds, cfg, icfg, extractor=ex, ann=ann, ann_kwargs=kw,
                            shortlist_k=ds.n, device="cpu")
    assert _map(full) == pytest.approx(_map(exact), abs=1e-9)


def test_ann_starved_shortlist_is_a_lower_bound(ann_setup):
    ds, cfg, ex, icfg, exact = ann_setup
    starved = evaluate_dataset(ds, cfg, icfg, extractor=ex, ann="ivf",
                               ann_kwargs={"n_clusters": 8, "nprobe": 1}, shortlist_k=5,
                               device="cpu")
    assert _map(starved) <= _map(exact) + 1e-9
    pq = evaluate_dataset(ds, cfg, icfg, extractor=ex, ann="pq",
                          ann_kwargs={"m": 8, "opq_iters": 1}, shortlist_k=5, device="cpu")
    assert 0.0 <= _map(pq) <= 1.0


@pytest.mark.parametrize("bad", [{"ann": "ivf", "qe_nqe": 3}, {"ann": "pq", "diffusion": True},
                                 {"ann": "ivf", "use_sharded_index": True},
                                 {"ann": "approx", "ann_kwargs": {"nprobe": 2}},
                                 {"ann": "hnsw"}])
def test_ann_refusals(ann_setup, bad):
    ds, cfg, ex, icfg, _ = ann_setup
    # ann="approx" is ported (the exact shortlist) and takes recall_target only
    match = {"approx": "only recall_target", "hnsw": "unknown ann"}.get(bad["ann"],
                                                                       "ann evaluation")
    with pytest.raises(ValueError, match=match):
        evaluate_dataset(ds, cfg, icfg, extractor=ex, device="cpu", **bad)
