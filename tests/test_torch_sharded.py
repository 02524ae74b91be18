"""Port parity: multi-device exact search (``parallel/``) on an 8-shard CPU
mesh against the JAX package's ``sharded_knn`` on its 8 virtual devices
(tests/conftest.py) and against the port's single-device search; the mesh
and process-group helpers; graded config 4 at toy scale with its exactness
probe; a sharded-index artifact crossing the two packages.

Shard borders fall inside runs of duplicated rows, so a score that came out
with other bits in a shard than on one device would reorder a tie and show.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irtpu.parallel import ShardedIndex as JShardedIndex
from irtpu.parallel import create_mesh as j_create_mesh
from irtpu.retrieval.index import Index as JIndex
from irtpu.retrieval.knn import knn_search as j_knn
from irtpu.utils.config import IndexConfig as JIndexConfig

from image_retrieval_for_image_based_localization_tpu_torch import benchmarks
from image_retrieval_for_image_based_localization_tpu_torch.parallel import (
    ShardedIndex,
    create_mesh,
    default_mesh,
    sharded_knn,
)
from image_retrieval_for_image_based_localization_tpu_torch.parallel.distributed import (
    all_gather_cols,
    all_reduce_sum,
    initialize_distributed,
    is_primary,
)
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.index import Index
from image_retrieval_for_image_based_localization_tpu_torch.retrieval.knn import (
    knn_search,
    rank_candidates,
)
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


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return j_create_mesh([1, 8])


def _gallery(case, seed=0):
    """(gallery, queries) for each case of the sharded search."""
    rng = np.random.RandomState(seed)
    if case == "n_valid_not_divisible":          # 133 rows: 17 a shard, shard 7 has 14
        g = rng.randn(133, 32)
    elif case == "empty_shards":                 # 9 rows: 2 a shard, shards 5-7 all pad
        g = rng.randn(9, 16)
    elif case == "duplicates_across_borders":    # runs of 5 copies over 24-row shards
        g = np.repeat(rng.randn(37, 24), 5, axis=0)
    else:                                        # all scores negative
        g = -np.abs(rng.randn(101, 16)) - 5.0
    q = rng.randn(7, g.shape[1])
    return g.astype(np.float32), q.astype(np.float32)


CASES = ["n_valid_not_divisible", "empty_shards", "duplicates_across_borders", "all_negative"]


@pytest.mark.parametrize("k", [3, 40, 1000])
@pytest.mark.parametrize("case", CASES)
def test_sharded_knn_matches_single_device_and_jax(mesh, jmesh, case, k):
    g, q = _gallery(case)
    si = ShardedIndex(g, mesh=mesh)
    assert len(si.shards) == 8 and all(s.shape[0] == si.local_rows for s in si.shards)
    s, i = si.query(q, k=k)
    kk = min(k, len(g))
    assert i.shape == (len(q), kk) and i.dtype == np.int32 and (i < len(g)).all()
    s1, i1 = knn_search(torch.from_numpy(g), torch.from_numpy(q), kk)
    np.testing.assert_array_equal(i, i1.numpy())
    np.testing.assert_array_equal(s, s1.numpy())   # the same bits per (query, row)
    js, ji = JShardedIndex(g, mesh=jmesh).query(q, k=k)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-5)


def test_k_above_local_rows_and_ties_go_to_the_lower_row(mesh):
    """One-hot rows planted on shards 0 and 4 (as the JAX package's tie
    test): the global lower row wins; k = 20 exceeds the 8 local rows."""
    g = np.zeros((64, 8), np.float32)
    g[3] = g[35] = g[60] = np.eye(8, dtype=np.float32)[0]
    g[10:20, 1] = 1.0
    q = np.eye(8, dtype=np.float32)[:2]
    s, i = ShardedIndex(g, mesh=mesh).query(q, k=20)
    assert list(i[0, :3]) == [3, 35, 60] and list(i[1, :10]) == list(range(10, 20))
    _, i1 = knn_search(torch.from_numpy(g), torch.from_numpy(q), 20)
    np.testing.assert_array_equal(i, i1.numpy())


def test_sharded_from_whitened_index(mesh, jmesh):
    rng = np.random.RandomState(2)
    g = np.repeat(rng.randn(40, 24).astype(np.float32), 2, axis=0)
    q = rng.randn(5, 24).astype(np.float32)
    index = Index.build(g, IndexConfig(whitening="pca"), device="cpu")
    si = ShardedIndex.from_index(index, mesh=mesh)
    s, i = si.query(q, k=12)
    _, i1 = knn_search(index.device_gallery(), index.transform_queries(q), 12)
    np.testing.assert_array_equal(i, i1.numpy())
    jindex = JIndex.build(g, JIndexConfig(whitening="pca"))
    js, ji = JShardedIndex.from_index(jindex, mesh=jmesh).query(q, k=12)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_sharded_rank_candidates_matches_single_device_and_jax(mesh, jmesh, case):
    g, q = _gallery(case, seed=1)
    rng = np.random.RandomState(3)
    cand = np.stack([rng.choice(len(g), min(6, len(g)), replace=False) for _ in q])
    r = ShardedIndex(g, mesh=mesh).rank_candidates(q, cand, chunk=8)
    r1 = rank_candidates(torch.from_numpy(g), torch.from_numpy(q), torch.from_numpy(cand))
    np.testing.assert_array_equal(r, r1.numpy())
    jr = JShardedIndex(g, mesh=jmesh).rank_candidates(q, cand.astype(np.int32), chunk=8)
    np.testing.assert_array_equal(r, np.asarray(jr))
    # the ranks are the candidates' places in NumPy's stable argsort
    pos = np.argsort(np.argsort(-(q @ g.T), axis=1, kind="stable"), axis=1)
    np.testing.assert_array_equal(r, np.take_along_axis(pos, cand, 1))


def test_sharded_knn_takes_tensor_shards(mesh):
    """The functional core: shards as tensors, n_valid below the padding."""
    g, q = _gallery("n_valid_not_divisible", seed=4)
    si = ShardedIndex(g, mesh=mesh)
    s, i = sharded_knn(si.shards, torch.from_numpy(q), 25, mesh, n_valid=120)
    _, i1 = knn_search(torch.from_numpy(g[:120]), torch.from_numpy(q), 25)
    np.testing.assert_array_equal(i.numpy(), i1.numpy())


def test_artifacts_cross_the_packages(mesh, jmesh, tmp_path):
    g, q = _gallery("duplicates_across_borders", seed=5)
    rng = np.random.RandomState(5)
    m = rng.randn(24).astype(np.float32) * 0.01
    P = np.linalg.qr(rng.randn(24, 24))[0].astype(np.float32)
    JShardedIndex(g, mesh=jmesh, m=m, P_=P).save(str(tmp_path / "j.npz"))
    t = ShardedIndex.load(str(tmp_path / "j.npz"), mesh=mesh, device="cpu")
    assert t.n_valid == len(g) and t.P is not None
    s, i = t.query(q, k=30)
    js, ji = JShardedIndex.load(str(tmp_path / "j.npz"), mesh=jmesh).query(q, k=30)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-5)
    t.save(str(tmp_path / "t.npz"))  # the shards gathered back into one Index
    back = JIndex.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(back.gallery), g)
    np.testing.assert_array_equal(back.P, P)


def test_mesh_layout_and_refusals():
    m = create_mesh([1, -1], devices=["cpu"] * 4)
    assert m.shape == {"data": 1, "gallery": 4} and m.local_shards == 4
    assert [m.shard_id(j) for j in range(4)] == [0, 1, 2, 3]
    assert create_mesh([4], axis_names=("gallery",), devices=["cpu"] * 4).shape == {"gallery": 4}
    assert default_mesh("cpu").shape == {"data": 1, "gallery": 1}
    # a data axis (ported): shard s at (s // 2, s % 2); the search uses the
    # first data row's two gallery shards, the other row holds replicas
    m = create_mesh([2, 2], devices=["cpu"] * 4)
    assert [(m.data_index(j), m.gallery_index(j)) for j in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert m.gallery_shards == [0, 1] and m.data_rows == [0, 2]
    with pytest.raises(ValueError, match="mesh"):
        create_mesh([1, 3], devices=["cpu"] * 4)


def test_one_process_needs_no_group(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed("127.0.0.1:1", num_processes=1, process_id=0) is False
    assert is_primary()
    t = torch.arange(6.0).reshape(2, 3)
    assert all_gather_cols(t) is t and all_reduce_sum(t) is t


@pytest.fixture(scope="module")
def config4_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("config4")
    small = dataclasses.replace(
        GRADED_CONFIGS[4],
        extract=ExtractConfig(model=ModelConfig(arch="resnet18", dtype="bfloat16"),
                              image_size=64, batch_size=8))
    mp = pytest.MonkeyPatch()
    mp.setitem(benchmarks.GRADED_CONFIGS, 4, small)
    mp.setitem(benchmarks.GALLERY_SCALE, 4, 3001)
    log = str(tmp / "config4.jsonl")
    try:
        out = benchmarks.run_graded_config(
            4, synth_root=str(tmp / "synth"), data_root=str(tmp / "nodata"),
            logger=metrics.MetricsLogger(path=log), device="cpu")
    finally:
        mp.undo()
    return out, [json.loads(line) for line in open(log)]


def test_config4_runs_with_its_exactness_probe(config4_run):
    out, lines = config4_run
    assert out == {"config": "r101-gem-100k-sharded", "top1_in_core": out["top1_in_core"]}
    assert out["top1_in_core"] > 0.8  # real core neighbours beat 3k random rows
    timed = next(r for r in lines if "queries_per_sec" in r)
    assert timed["gallery"] == 3001 and timed["storage"] == "float32"
    assert timed["mesh"] == {"data": 1, "gallery": 1} and timed["world_size"] == 1
    assert timed["lat_p99_s"] >= timed["lat_p50_s"] > 0
    probe = next(r for r in lines if r.get("event") == "exactness_probe")
    assert probe["sharded_equals_single_device"] is True and probe["k"] == 100


def test_config4_probe_raises_on_a_mismatch(mesh, monkeypatch):
    """The exactness probe has teeth: a sharded answer that is not the
    single-device one raises."""
    rng = np.random.RandomState(6)
    core = rng.randn(30, 32).astype(np.float32)
    core /= np.linalg.norm(core, axis=1, keepdims=True)
    qd = core[:4] + 0.01
    monkeypatch.setitem(benchmarks.GALLERY_SCALE, 4, 500)
    res = benchmarks.run_gallery_scale(4, core, qd, [{}] * 4, device="cpu", mesh=mesh)
    assert res["exact_match"] and res["indices"].shape == (4, 100)
    assert len(res["sharded"].shards) == 8 and res["gallery"].dtype == torch.float32

    def shifted(*args, **kwargs):
        s, i = sharded_knn(*args, **kwargs)
        return s, torch.roll(i, 1, dims=1)

    monkeypatch.setattr(benchmarks, "sharded_knn", shifted)
    with pytest.raises(AssertionError, match="disagrees with single-device"):
        benchmarks.run_gallery_scale(4, core, qd, [{}] * 4, device="cpu", mesh=mesh)
