"""Port parity: the graded-config runner (``benchmarks.run_graded_config``)
at toy scale, the external-gallery bf16 index artifact across the two
packages, the NetVLAD k-means init and the metrics logger.

Config 5's path (bf16 trunk and fused head, a distractor-padded bf16
gallery whitened on the device, timed exact top-100, localization recall,
the pairs file and the memory-mapped artifact with its reload probe) runs
on the CPU with ``GRADED_CONFIGS`` and ``GALLERY_SCALE`` monkeypatched, as
tests/test_graded_configs.py runs the JAX package's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from irtpu.retrieval.index import Index as JIndex
from irtpu.training import netvlad_init as j_nvinit
from irtpu.utils import config as jcfg
from irtpu.utils import metrics as jmetrics
from irtpu.models.torch_port import port_retrieval_net

from image_retrieval_for_image_based_localization_tpu_torch import benchmarks
from image_retrieval_for_image_based_localization_tpu_torch.models import (
    RetrievalNet,
    init_random_,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.training import netvlad_init
from image_retrieval_for_image_based_localization_tpu_torch.utils import metrics
from image_retrieval_for_image_based_localization_tpu_torch.utils.config import (
    GRADED_CONFIGS,
    ExtractConfig,
    IndexConfig,
    ModelConfig,
)
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """bf16 <-> f32 copies on this CPU slow down sharply with many threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _lines(path):
    return [json.loads(line) for line in open(path)]


@pytest.fixture(scope="module")
def config5_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("config5")
    small = dataclasses.replace(
        GRADED_CONFIGS[5],
        extract=ExtractConfig(model=ModelConfig(arch="resnet18", dtype="bfloat16",
                                                use_pallas=True),
                              image_size=96, batch_size=8),
        index=IndexConfig(whitening="pca"),
    )
    mp = pytest.MonkeyPatch()
    mp.setitem(benchmarks.GRADED_CONFIGS, 5, small)
    mp.setitem(benchmarks.GALLERY_SCALE, 5, 3000)
    log = str(tmp / "config5.jsonl")
    try:
        out = benchmarks.run_graded_config(
            5, synth_root=str(tmp / "synth"), data_root=str(tmp / "nodata"),
            logger=metrics.MetricsLogger(path=log), out_dir=str(tmp / "artifacts"),
            device="cpu")
    finally:
        mp.undo()
    return out, _lines(log), tmp / "artifacts"


def test_config5_path_with_artifacts(config5_run):
    out, lines, art_dir = config5_run
    assert out["config"] == "aachen-1m-pod"
    assert out["top1_in_core"] > 0.8  # real core neighbours beat 3k random rows
    events = {line.get("event") for line in lines}
    assert {"localization_recall", "pairs_written", "index_artifact", "provenance"} <= events
    rec = next(r for r in lines if r.get("event") == "localization_recall")
    assert 1.0 >= rec["recall_at_20"] >= rec["recall_at_1"] >= 0.0
    timed = next(r for r in lines if "queries_per_sec" in r)
    assert timed["gallery"] == 3000 and timed["storage"] == "bfloat16"
    assert timed["lat_p99_s"] >= timed["lat_p50_s"] > 0
    prov = next(r for r in lines if r.get("event") == "provenance")
    assert prov["backend"] == "cpu" and prov["n_devices"] == 1

    pairs = [line.split() for line in open(art_dir / "config5_pairs.txt") if line.strip()]
    assert len(pairs) == 6 * 20 and all(len(p) == 2 for p in pairs)
    assert pairs[0][0].startswith("q_s0") and pairs[0][1].startswith(("db_", "distractor"))

    art = next(r for r in lines if r.get("event") == "index_artifact")
    assert art["reload_query_probe"] == "exact"
    sidecar = art_dir / "config5_index.gallery.npy"
    assert os.path.getsize(sidecar) == art["gallery_sidecar_bytes"]
    assert np.load(sidecar, mmap_mode="r").dtype == np.uint16


def test_config5_artifact_loads_in_jax_with_equal_bits(config5_run):
    """The port's external bf16 artifact in the JAX package: the same
    gallery bits (as ml_dtypes bf16), whitening and search results."""
    _, _, art_dir = config5_run
    path = str(art_dir / "config5_index.npz")
    t = Index.load(path, device="cpu")
    j = JIndex.load(path)
    assert isinstance(t.gallery, np.memmap) and t.gallery.dtype == np.uint16
    assert j.gallery.dtype == ml_dtypes.bfloat16 and t.gallery.shape == (3000, 512)
    np.testing.assert_array_equal(np.asarray(j.gallery).view(np.uint16), t.gallery)
    np.testing.assert_array_equal(t.P, j.P)
    assert t.device_gallery().dtype == torch.bfloat16
    q = np.random.RandomState(0).randn(3, 512).astype(np.float32)
    _, it = t.query(q, k=5)
    _, ij = j.query(q, k=5)
    np.testing.assert_array_equal(it, np.asarray(ij))


def test_jax_external_bf16_artifact_loads_in_port_without_widening(tmp_path):
    rng = np.random.RandomState(1)
    g = rng.randn(300, 32).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    gb = g.astype(ml_dtypes.bfloat16)
    m = rng.randn(32).astype(np.float32) * 0.01
    P = np.linalg.qr(rng.randn(32, 32))[0].astype(np.float32)
    JIndex(gallery=gb, m=m, P=P, storage="bfloat16").save(str(tmp_path / "j.npz"),
                                                         external_gallery=True)
    t = Index.load(str(tmp_path / "j.npz"), device="cpu")
    # no f32 host copy: the sidecar stays a uint16 memory map of the bf16 bits
    assert isinstance(t.gallery, np.memmap) and t.gallery.dtype == np.uint16
    np.testing.assert_array_equal(t.gallery, gb.view(np.uint16))
    dg = t.device_gallery()
    assert dg.dtype == torch.bfloat16
    np.testing.assert_array_equal(dg.view(torch.int16).numpy().view(np.uint16),
                                  gb.view(np.uint16))
    q = rng.randn(4, 32).astype(np.float32)
    s_t, i_t = t.query(q, k=10)
    s_j, i_j = JIndex.load(str(tmp_path / "j.npz")).query(q, k=10)
    np.testing.assert_array_equal(i_t, np.asarray(i_j))
    np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=0, atol=1e-6)
    # saved again by the port (in-npz and external) it round-trips bit for bit
    for external in (False, True):
        t.save(str(tmp_path / f"t{external}.npz"), external_gallery=external)
        back = JIndex.load(str(tmp_path / f"t{external}.npz"))
        np.testing.assert_array_equal(np.asarray(back.gallery).view(np.uint16),
                                      gb.view(np.uint16))
    assert not os.path.exists(str(tmp_path / "tTrue.gallery.npy.tmp"))


def test_device_bf16_gallery_saves_as_bits(tmp_path):
    """An Index holding a bf16 tensor (run_gallery_scale's gallery) saves
    its bits; the f32 gallery's layout is unchanged."""
    g = torch.nn.functional.normalize(torch.randn(50, 16, generator=torch.Generator()
                                                  .manual_seed(2)), dim=1)
    Index(gallery=g.to(torch.bfloat16), storage="bfloat16", device=torch.device("cpu")).save(
        str(tmp_path / "b.npz"))
    back = JIndex.load(str(tmp_path / "b.npz"))
    np.testing.assert_array_equal(np.asarray(back.gallery).astype(np.float32),
                                  g.to(torch.bfloat16).float().numpy())
    Index(gallery=g, device=torch.device("cpu")).save(str(tmp_path / "f.npz"))
    assert JIndex.load(str(tmp_path / "f.npz")).gallery.dtype == np.float32


def test_config4_waits_for_sharded_search(monkeypatch):
    """Config 4 no longer waits: its gallery-scale body runs sharded on the
    default mesh (one CPU shard here), f32, with the exactness probe
    (tests/test_torch_sharded.py runs the whole config at toy scale)."""
    rng = np.random.RandomState(0)
    core = rng.randn(8, 16).astype(np.float32)
    core /= np.linalg.norm(core, axis=1, keepdims=True)
    monkeypatch.setitem(benchmarks.GALLERY_SCALE, 4, 400)
    res = benchmarks.run_gallery_scale(4, core, core[:3], [{}] * 3, device="cpu")
    assert res["exact_match"] and res["gallery"].dtype == torch.float32
    assert res["sharded"].mesh.shape == {"data": 1, "gallery": 1}
    assert (res["indices"][:, 0] == np.arange(3)).all() and res["top1_in_core"] == 1.0


def test_config1_eval_logs_map_and_provenance(tmp_path, monkeypatch):
    small = dataclasses.replace(
        GRADED_CONFIGS[1],
        extract=ExtractConfig(model=ModelConfig(arch="resnet18"), image_size=96,
                              batch_size=8, scales=(1.0,)),
    )
    monkeypatch.setitem(benchmarks.GRADED_CONFIGS, 1, small)
    log = str(tmp_path / "config1.jsonl")
    out = benchmarks.run_graded_config(1, synth_root=str(tmp_path / "synth"),
                                       data_root=str(tmp_path / "nodata"),
                                       logger=metrics.MetricsLogger(path=log), device="cpu")
    lines = _lines(log)
    mrec = next(r for r in lines if r.get("event") == "map")
    for proto in ("easy", "medium", "hard"):
        assert mrec[f"map_{proto}"] == out["map"][proto]["map"]
        assert len(mrec[f"mp_at_k_{proto}"]) == 3
    prov = [r for r in lines if r.get("event") == "provenance"]
    assert prov and all(p["ranking_path"] == "dense" and p["backend"] == "cpu" for p in prov)
    assert {"extract_db", "extract_queries", "build_index", "rank"} <= {
        r.get("phase") for r in lines}


def test_config3_runs_with_kmeans_init(tmp_path, monkeypatch):
    """Config 3's path: NetVLAD head set by k-means over the corpus, then the
    evaluation (vgg16 at a toy size, K = 4)."""
    small = dataclasses.replace(
        GRADED_CONFIGS[3],
        extract=ExtractConfig(model=ModelConfig(arch="vgg16", pooling="netvlad",
                                                netvlad_clusters=4, use_pallas=True),
                              image_size=48, batch_size=8),
        index=IndexConfig(whitening="pca", whiten_dims=64),
    )
    monkeypatch.setitem(benchmarks.GRADED_CONFIGS, 3, small)
    log = str(tmp_path / "config3.jsonl")
    out = benchmarks.run_graded_config(3, synth_root=str(tmp_path / "synth"),
                                       data_root=str(tmp_path / "nodata"),
                                       logger=metrics.MetricsLogger(path=log), device="cpu")
    lines = _lines(log)
    assert any(r.get("event") == "netvlad_kmeans_init" and r["clusters"] == 4 for r in lines)
    assert 0.0 <= out["map"]["medium"]["map"] <= 1.0


_port_kmeans = netvlad_init.kmeans


def _jax_init_kmeans(x, k, iters=25, generator=None, init=None):
    """The port's kmeans from the rows the JAX package's init picks."""
    rows = np.array(jax.random.choice(jax.random.PRNGKey(generator.initial_seed()),
                                      x.shape[0], shape=(k,), replace=False))
    return _port_kmeans(x, k, iters=iters, init=x[torch.from_numpy(rows)])


def test_netvlad_init_from_images_matches_jax(monkeypatch):
    """The sampled trunk features, the paper's head init and, from the JAX
    package's k-means start, the head itself."""
    from irtpu.models import RetrievalNet as JNet

    net = RetrievalNet("resnet18", "netvlad", netvlad_clusters=4)
    init_random_(net, torch.Generator().manual_seed(4))
    net.eval()
    sd = net.state_dict()
    variables = jax.tree.map(jnp.asarray, port_retrieval_net(sd, "resnet18"))
    jnet = JNet(arch="resnet18", pooling="netvlad", netvlad_clusters=4)
    rng = np.random.RandomState(2)
    imgs = [(rng.rand(128, 96 + 16 * i, 3) * 255).astype(np.uint8) for i in range(4)]
    cfg = ExtractConfig(model=ModelConfig(arch="resnet18", pooling="netvlad",
                                          netvlad_clusters=4), image_size=128, batch_size=2)
    jc = jcfg.ExtractConfig(model=jcfg.ModelConfig(arch="resnet18", pooling="netvlad",
                                                   netvlad_clusters=4), image_size=128,
                            batch_size=2)
    f_t = netvlad_init.collect_local_features(net, imgs, cfg, per_image=8, seed=1)
    f_j = j_nvinit.collect_local_features(jnet, variables, imgs, jc, per_image=8, seed=1)
    assert f_t.shape == f_j.shape == (32, 512)
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=2e-4)

    c = np.random.RandomState(3).randn(4, 512).astype(np.float32)
    for key, v in j_nvinit.init_netvlad_params(c, alpha=50.0).items():
        np.testing.assert_array_equal(netvlad_init.init_netvlad_params(c, alpha=50.0)[key], v)

    monkeypatch.setattr(netvlad_init, "kmeans", _jax_init_kmeans)
    sd2 = netvlad_init.init_netvlad_from_images(net, imgs, cfg, kmeans_iters=5, seed=3)
    v2 = j_nvinit.init_netvlad_from_images(jnet, variables, imgs, jc, kmeans_iters=5, seed=3)
    got = port_retrieval_net(sd2, "resnet18")["params"]
    for key in ("centroids", "assign_w", "assign_b"):
        np.testing.assert_allclose(got[key], np.asarray(v2["params"][key]), rtol=1e-4,
                                   atol=1e-3)
    # the trunk is untouched and the new head runs
    assert torch.equal(sd2["features.conv1.weight"], sd["features.conv1.weight"])
    net2 = RetrievalNet("resnet18", "netvlad", netvlad_clusters=4)
    net2.load_state_dict(sd2)
    with torch.no_grad():
        d = net2.eval()(torch.from_numpy(rng.randn(1, 64, 64, 3).astype(np.float32)))
    assert d.shape == (1, 2048) and torch.isfinite(d).all()


def test_metrics_logger_and_percentiles_match_jax(tmp_path, capsys):
    lat = np.random.RandomState(5).rand(37) * 0.01
    assert metrics.percentile_summary(lat) == jmetrics.percentile_summary(lat)
    assert metrics.percentile_summary(lat, "s") == jmetrics.percentile_summary(lat, "s")
    for mod, name in ((metrics, "t"), (jmetrics, "j")):
        logger = mod.MetricsLogger(path=str(tmp_path / name / "m.jsonl"), echo=True)
        logger.log(a=1, t=0.0)
        with mod.phase_timer("p", logger, items=4):
            pass
    t, j = _lines(tmp_path / "t" / "m.jsonl"), _lines(tmp_path / "j" / "m.jsonl")
    assert t[0] == j[0] == {"a": 1, "t": 0.0}
    assert set(t[1]) == set(j[1]) == {"phase", "seconds", "items_per_sec", "t"}
    assert capsys.readouterr().out.count('"a": 1') == 2
